"""Logical-axis sharding rules over a ``DeviceMesh`` (port of
``repro.distributed.sharding``).

Every parameter carries its logical axes (``models.layers.param_axes``);
this module maps logical names onto mesh axes.  One rule table serves
every architecture.  Default mapping on the production mesh ("pod",
"data", "model"):

  embed  -> "data"    FSDP: parameters and optimizer state over DP ranks
  vocab  -> "model"   TP: embedding and logits over tensor ranks
  heads  -> "model"   TP over attention heads
  kv     -> "model"   TP over kv heads (replicated if indivisible)
  mlp    -> "model"   TP over the FFN hidden dim
  inner  -> "model"   TP over the SSM inner dim
  expert -> "model"   EP: experts over tensor ranks
  lora   -> None      MLA's compressed streams are small; replicated
  stack  -> None      the reference's scan axis; the port has none

A spec is a :class:`P`, a tuple with one entry a tensor dimension: a mesh
axis name, a tuple of names (split in that order), or None; it compares
entry by entry with the reference's ``PartitionSpec``.
:func:`placements` turns it into DTensor placements, :func:`distribute_model`
turns a model's parameters into DTensors, and inside
:func:`activation_sharding` the models' :func:`shard_act` calls redistribute
their DTensor activations to the reference's standard layouts.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from types import SimpleNamespace

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

LOGICAL_RULES: dict = {
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "inner": "model",
    "expert": "model",
    "lora": None,
    "conv": None,
    "stack": None,
    None: None,
}


class P(tuple):
    """A partition spec: ``P("data", None, "model")``; trailing
    unsharded dimensions are left out, as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def partition_spec(axes: tuple, shape: tuple, mesh,
                   rules: dict | None = None) -> P:
    """One parameter's logical axes -> its spec, dropping a mesh axis that
    does not divide its dimension (kv = 1 head on a 16-way tensor mesh ->
    replicated) or that an earlier dimension already took."""
    rules = rules or LOGICAL_RULES
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for ax_name, dim in zip(axes, shape):
        mesh_ax = rules.get(ax_name)
        if mesh_ax is None or mesh_ax in used or mesh_ax not in sizes:
            out.append(None)
            continue
        if dim % sizes[mesh_ax] != 0:
            out.append(None)
            continue
        out.append(mesh_ax)
        used.add(mesh_ax)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh axis that some tensor dimension names, ``Replicate()`` on the
    rest.  A dimension split over several axes is split in mesh order
    (the reference's ``("pod", "data")``).  An axis of one rank splits
    nothing: it takes ``Replicate()``, the same layout, which DTensor's
    views accept on a dimension of size 1."""
    out = []
    for name, size in axis_sizes(mesh).items():
        dims = [i for i, e in enumerate(spec) if name in _names(e)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def params_shardings(model: nn.Module, mesh,
                     rules: dict | None = None) -> dict:
    """``{parameter name: spec}`` of a model on ``mesh``."""
    out = {}
    for name, p in model.named_parameters():
        axes = getattr(p, "logical_axes", None)
        if axes is None:
            raise ValueError(
                f"parameter {name} has no logical axes (a load that "
                f"replaced it? models.layers.set_param_axes tags it again)")
        out[name] = partition_spec(axes, tuple(p.shape), mesh, rules)
    return out


def local_chunk(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a full tensor ``t`` under ``spec``: ``t`` itself
    where the block is all of it (a mesh of one rank copies nothing), else
    a copy of the block, so that the full tensor can be freed."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    block = t
    for dim, entry in enumerate(spec):
        for name in _names(entry):
            n = block.shape[dim] // sizes[name]
            block = block.narrow(dim, coord[name] * n, n)
    if block.shape == t.shape:
        return t.contiguous()
    return block.clone(memory_format=torch.contiguous_format)


def distribute(t: torch.Tensor, spec, mesh):
    """A DTensor of the full tensor ``t`` (the same on every rank) laid out
    by ``spec``, each rank keeping its own block: no communication."""
    return DTensor.from_local(local_chunk(t, spec, mesh), mesh,
                              placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=t.stride())


def local_block(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's block of the full tensor ``full`` in DTensor ``like``'s
    layout."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        like.shape, like.device_mesh, like.placements)
    for dim, (n, o) in enumerate(zip(shape, offset)):
        full = full.narrow(dim, o, n)
    return full


def like_param(g, p):
    """A DTensor gradient ``g`` in its parameter ``p``'s layout (partial
    sums reduced); anything else as it is."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _one_split_a_dim(x):
    """A DTensor ``x`` with each dimension split over at most one mesh axis:
    of a dimension split over several (the batch over "pod" and "data"),
    the innermost split is kept and the outer ones gathered."""
    pl = list(x.placements)
    for i, q in enumerate(pl):
        if q.is_shard() and any(r.is_shard(q.dim) for r in pl[i + 1:]):
            pl[i] = Replicate()
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


class _Rows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape = tuple(table.shape)
        one = _one_split_a_dim(tokens)
        out = table[one]
        if one is tokens:
            return out
        # the rows split again as the tokens were (a local chunk), so that
        # the gradient comes back split as they are and is not gathered
        pl = tuple(t if q == Replicate() and not o.is_shard() else q
                   for q, o, t in zip(out.placements, one.placements,
                                      tokens.placements))
        return out.redistribute(out.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        mesh, k = tokens.device_mesh, tokens.ndim
        # the gradient keeps its own splits (a partial sum reduced); the
        # tokens follow its splits of their dimensions and are whole
        # elsewhere, so the gradient, not the tokens, stays where it is
        g_pl = tuple(q if type(q) is Shard else Replicate()
                     for q in g.placements)
        gl = g.redistribute(mesh, g_pl).to_local()
        tl = tokens.redistribute(mesh, tuple(
            q if q.is_shard() and q.dim < k else Replicate()
            for q in g_pl)).to_local()
        grad = gl.new_zeros((ctx.shape[0], *gl.shape[k:])).index_put_(
            (tl,), gl, accumulate=True)
        # a split of the tokens leaves each rank a partial sum; a split of
        # the gradient's features splits the table's
        out_pl = tuple(Partial() if q.is_shard() and q.dim < k
                       else Shard(q.dim - k + 1) if q.is_shard()
                       else Replicate() for q in g_pl)
        stride = tuple(math.prod(ctx.shape[i + 1:])
                       for i in range(len(ctx.shape)))
        return DTensor.from_local(grad, mesh, out_pl, run_check=False,
                                  shape=ctx.shape, stride=stride), None


def rows(table, tokens):
    """``table[tokens]``.  On a DTensor table the backward (each token's
    gradient summed into its row) runs on each rank's own block of the
    gradient as it arrives, the tokens gathered to match it: a split of
    the tokens' dimensions leaves partial sums of the table, a split of
    the features a split table.  PyTorch 2.11's sharding rule for that
    ``index_put`` maps a gradient split over its batch onto the table as
    an unnormalised ``Shard(-1)`` and raises.  And its rule for the gather
    refuses tokens with a dimension split over two mesh axes (the batch
    over "pod" and "data"): the gather takes them with the outer split
    gathered (the tokens only, not the table)."""
    if not isinstance(table, DTensor):
        return table[tokens]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, table.device_mesh,
                                    (Replicate(),) * table.device_mesh.ndim,
                                    run_check=False)
    return _Rows.apply(table, tokens)


def full(x):
    """A DTensor's full value as a plain tensor; anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def batch_placements(mesh, batch: int) -> tuple:
    """Placements of a tensor split over the DP axes by its leading
    (batch) dimension, where they divide it, and whole elsewhere."""
    return placements(P(dp_entry(mesh, batch)), mesh)


def spec_of(x) -> P:
    """The spec of DTensor ``x``'s layout: each dimension with the mesh
    axes that split it, in mesh order (a partial sum is not a split)."""
    dims = [[] for _ in range(x.ndim)]
    for name, q in zip(x.device_mesh.mesh_dim_names, x.placements):
        if q.is_shard():
            dims[q.dim].append(name)
    out = [None if not d else d[0] if len(d) == 1 else tuple(d)
           for d in dims]
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def seq_split(t) -> bool:
    """Whether a DTensor's sequence (dimension 1) is split."""
    return isinstance(t, DTensor) and any(
        q.is_shard(1) for q in t.placements)


def sequence_whole(x):
    """A DTensor ``x`` [B, S, ...] whose sequence is split (``seq_sharded``,
    ``residual_seq_parallel``) with its sequence whole: each mesh axis that
    splits the sequence splits the batch instead where it is a DP axis and
    the batch's splits still divide B (an all-to-all), and is whole
    otherwise (an all-gather); the batch's own splits stay.  Its gradient
    goes back to ``x``'s own layout.  Anything else as it is.

    The models call it where a block takes the residual stream, as
    Megatron's sequence parallelism gathers the sequence before a block's
    column-parallel products: PyTorch 2.11's DTensor refuses the flatten
    of a split sequence that a product [B, S, d] @ [d, f] makes, and 2.13's
    strided layout of it takes the MoE's dispatch groups apart into the
    wrong tokens."""
    if not seq_split(x):
        return x
    mesh = x.device_mesh
    dp = _names(_dp(mesh))
    split = math.prod(mesh.size(i) for i, q in enumerate(x.placements)
                      if q.is_shard(0))
    pl = []
    for i, (name, q) in enumerate(zip(mesh.mesh_dim_names, x.placements)):
        if q.is_shard(1):
            if name in dp and x.shape[0] % (split * mesh.size(i)) == 0:
                q, split = Shard(0), split * mesh.size(i)
            else:
                q = Replicate()
        pl.append(q)
    return x.redistribute(mesh, tuple(pl))


def block_range(x, dim: int) -> tuple:
    """(start, stop) of this rank's block of DTensor ``x``'s dimension
    ``dim``, which its splits divide evenly (nested in mesh order, as
    :func:`placements` lays them out).  Plain arithmetic on the mesh
    coordinate, so it holds under ``FakeTensorMode`` too."""
    mesh, n = x.device_mesh, x.shape[dim]
    start = 0
    for i, (c, q) in enumerate(zip(mesh.get_coordinate(), x.placements)):
        if q.is_shard(dim):
            n //= mesh.size(i)
            start += c * n
    return start, start + n


def write_position(buf, pos: int, value) -> None:
    """``buf[:, pos] = value[:, 0]`` in place, cast to ``buf``'s type, for
    a cache ``buf`` [B, T, ...] and a new entry ``value`` [B, 1, ...].

    On a DTensor cache each rank writes its own block: the one rank (on
    each other axis) whose block of the sequence holds global position
    ``pos`` writes it at its local index, the others write nothing.  The
    new entry goes to the cache's layout with its sequence whole, which
    moves the entry only, never the cache.  (DTensor's own ``buf[:, pos] =
    ...`` on a split sequence writes into a gathered copy, and the cache
    does not change.)"""
    if not isinstance(buf, DTensor):
        buf[:, pos] = value[:, 0].to(buf.dtype)
        return
    mesh = buf.device_mesh
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
    entry = value.redistribute(mesh, tuple(
        Replicate() if q.is_shard(1) else q for q in buf.placements))
    start, stop = block_range(buf, 1)
    if start <= pos < stop:
        buf.to_local()[:, pos - start] = entry.to_local()[:, 0].to(buf.dtype)


def on_local_blocks(fn, operands, specs, out_spec, mesh, partial=None,
                    **kw):
    """``fn(*blocks, **kw)`` on each rank's own blocks, for a block whose
    ops have no DTensor rule that holds up (or whose rules are slow to
    search): operand i laid out by ``specs[i]``, the result back as a
    DTensor laid out by ``out_spec``, and a partial sum over the mesh axes
    of the spec entry ``partial`` (those that split a dimension ``fn``
    contracts).
    Every rank computes its own block of the result, so an operand whole
    on a mesh axis that splits the result gets its gradient as partial
    sums over that axis; elsewhere its gradient comes back in its own
    layout."""
    out_pl = tuple(Partial() if name in _names(partial) else q for name, q
                   in zip(mesh.mesh_dim_names, placements(out_spec, mesh)))

    def block(t, spec):
        pl = placements(spec, mesh)
        grad_pl = tuple(Partial() if o.is_shard() and not q.is_shard()
                        else q for q, o in zip(pl, out_pl))
        return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    out = fn(*(block(t, s) for t, s in zip(operands, specs)), **kw)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def on_batch_shards(fn, module: nn.Module, x, *args):
    """``fn(params, x_local, *args)`` on each rank's batch block of the
    DTensor ``x``, with ``module``'s parameters gathered whole (a
    namespace of plain tensors); the result back as a DTensor split the
    same way.  For a block whose ops have no DTensor sharding rule that
    holds up (the SSM scan): data-parallel over its batch, each weight's
    gradient the sum of the ranks' partial ones."""
    mesh = x.device_mesh
    names, weights = zip(*module.named_parameters())
    spec = P(dp_entry(mesh, x.shape[0]))

    def run(x_local, *ws):
        return fn(SimpleNamespace(**dict(zip(names, ws))), x_local, *args)
    return on_local_blocks(run, (x, *weights),
                           (spec,) + (P(),) * len(weights), spec, mesh)


@contextlib.contextmanager
def index_arithmetic_unfaked():
    """For DTensors under ``FakeTensorMode`` (the dry-run): DTensor
    computes a strided shard's local size (a batch and a sequence dim
    split over two axes, then flattened) from a small ``torch.arange`` it
    builds and reads back; under the fake mode that tensor is fake and
    cannot be read.  Run that index arithmetic on real tensors (it touches
    no model data)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    name = "local_shard_size_and_offset"
    orig = _StridedShard.__dict__.get(name)
    if orig is None:
        yield
        return
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig

    def real(*a, **k):
        with unset_fake_temporarily():
            return fn(*a, **k)

    setattr(_StridedShard, name,
            staticmethod(real) if isinstance(orig, staticmethod) else real)
    try:
        yield
    finally:
        setattr(_StridedShard, name, orig)


def distribute_model(model: nn.Module, mesh,
                     rules: dict | None = None) -> nn.Module:
    """Turn ``model``'s parameters into DTensors on ``mesh``, in place, by
    :func:`params_shardings`.  Every rank holds the same full parameters
    (seeded weights) and keeps its own block of each: no communication."""
    specs = params_shardings(model, mesh, rules)
    for mod_name, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None or isinstance(p.data, DTensor):
                continue
            spec = specs[f"{mod_name}.{name}" if mod_name else name]
            new = nn.Parameter(distribute(p.data, spec, mesh),
                               requires_grad=p.requires_grad)
            new.logical_axes = p.logical_axes
            setattr(mod, name, new)
    return model


def _dp(mesh):
    """The spec entry of the DP axes ("pod" and "data", those the mesh
    has): one name, or a tuple of both."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return dp[0] if len(dp) == 1 else dp


def dp_entry(mesh, dim: int):
    """The spec entry of a batch dimension of size ``dim``: the DP axes,
    None where they do not divide it."""
    dp = _dp(mesh)
    return dp if dp and _div(dim, mesh, dp) else None


def _split_dividing(x, dim: int, n: int):
    """A DTensor ``x`` whose splits of dimension ``dim`` multiply to a
    divisor of ``n``: the outermost splits are gathered until they do."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh, pl = x.device_mesh, list(x.placements)
    split = [i for i, q in enumerate(pl)
             if isinstance(q, Shard) and q.dim == dim]
    while split and n % math.prod(mesh.size(i) for i in split):
        pl[split.pop(0)] = Replicate()
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


class _Divisible(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.n = dim, n
        return _split_dividing(x, dim, n)

    @staticmethod
    def backward(ctx, g):
        return _split_dividing(g, ctx.dim, ctx.n), None, None


class _InLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def in_layout(x):
    """``x``, where a DTensor, whose gradient comes back in ``x``'s own
    layout (partial sums reduced): for a parameter used twice, such as
    tied embeddings, so that its two gradients add in one layout (DTensor
    cannot turn a split gradient into a partial one to add it).  A plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return _InLayout.apply(x)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        local = g.to_local()
        if local.is_contiguous():
            return g
        return DTensor.from_local(local.contiguous(), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())


def contiguous_grad(x):
    """``x``, where a DTensor, whose gradient comes back contiguous, its
    own block too.  DTensor's backward of a split keeps the stride its
    output's gradient had, where the plain backward makes it contiguous;
    on a dimension of size 1 (one kv head) that stride is free, and a
    reduction further back (``rms_norm``'s over the head dimension) then
    sums in another order.  And a gradient made of a block
    (:func:`on_local_blocks`) keeps the block's strides under contiguous
    global ones, which DTensor's views further back cannot take.  A plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return _ContiguousGrad.apply(x)


def divisible(x, dim: int, n: int):
    """``x``, where a DTensor, with dimension ``dim`` split over mesh axes
    whose sizes multiply to a divisor of ``n`` (the outer splits gathered
    first), and its gradient likewise: for a dimension that a view takes
    apart into (n, -1) or puts together from them, such as the flattened
    heads of an attention projection or the tokens of the MoE groups.  A
    plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return _Divisible.apply(x, dim, n)


def batch_spec(mesh, seq_sharded: bool = False) -> P:
    """Spec for [batch, seq, ...] activations: batch over the DP axes
    (pod + data); optionally the sequence over "data" (long context)."""
    if seq_sharded:
        return P(None, "data")
    return P(_dp(mesh))


# ---------------------------------------------------------------------------
# Activation layouts (context-scoped)
#
# The models call ``shard_act`` at the reference's call sites.  Inside an
# ``activation_sharding`` context a DTensor activation is redistributed to
# the standard layout (batch over DP, vocab and experts over "model");
# outside one, or on a plain tensor, the call returns its input.  Inside
# the context plain tensors (positions, masks, constants) meet DTensors as
# replicated ones (``implicit_replication``).

_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)


def residual_barrier(x):
    """The identity.  The reference pins the residual stream to bf16 with
    an optimization barrier (``bf16_all_reduce``), because XLA hoists the
    bf16->f32 convert of the next rms_norm above the tensor-parallel
    all-reduce and so doubles its bytes.  Eager PyTorch runs each op where
    the model writes it, so the block's reduction already carries the
    activations' own type."""
    return x


@contextlib.contextmanager
def activation_sharding(mesh, seq_sharded: bool = False,
                        attn_seq_parallel: bool = False,
                        residual_seq_parallel: bool = False,
                        bf16_all_reduce: bool = False):
    """attn_seq_parallel: shard the query sequence of attention over
    "model" (context parallelism), for head counts that do not divide the
    TP degree.  residual_seq_parallel: the residual stream [B, S, D] is
    sharded (DP, "model", -) between blocks (Megatron-style SP).
    bf16_all_reduce: kept for the reference's options; see
    :func:`residual_barrier`."""
    with _entered({"mesh": mesh, "seq": seq_sharded,
                   "attn_sp": attn_seq_parallel,
                   "sp": residual_seq_parallel, "bf16_ar": bf16_all_reduce}):
        yield


@contextlib.contextmanager
def _entered(ctx):
    """The activation-sharding context ``ctx`` (None: none)."""
    if ctx is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    tok = _ACT_CTX.set(ctx)
    try:
        with implicit_replication():
            yield
    finally:
        _ACT_CTX.reset(tok)


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: (the forward's context,
    the recompute's).  The recompute runs in the backward, which on a card
    runs on the autograd engine's own thread, where this thread's
    :func:`activation_sharding` context is not set; it enters the
    forward's context again, so that ``shard_act`` and
    :func:`moe_group_count` see what the forward saw."""
    return contextlib.nullcontext(), _entered(_ACT_CTX.get())


def _div(dim: int, mesh, axes) -> bool:
    if axes is None:
        return False
    sizes = axis_sizes(mesh)
    size = 1
    for a in _names(axes):
        if a not in sizes:
            return False
        size *= sizes[a]
    return dim % size == 0


def moe_group_count(tokens: int) -> int:
    """Dispatch groups of the grouped MoE: one per "data" rank, so each
    group's sort, capacity and scatter stay on its shard; 1 outside a mesh
    context or where the count does not divide the tokens.  (The reference
    also reads ``REPRO_MOE_GROUPS``; the port reads no environment
    variable: ``apply_moe(groups=)`` forces a count.)"""
    ctx = _ACT_CTX.get()
    if ctx is None:
        return 1
    g = axis_sizes(ctx["mesh"]).get("data", 1)
    return g if tokens % g == 0 else 1


def act_spec(shape, kind: str, ctx: dict):
    """The reference's layout of an activation of ``shape`` and ``kind``
    (None where it leaves the activation as it is)."""
    mesh = ctx["mesh"]
    dp = _dp(mesh)
    if kind == "hidden":
        if ctx["seq"] and _div(shape[1], mesh, "data"):
            return P("pod" if _div(shape[0], mesh, "pod") else None,
                     "data", None)
        if ctx.get("sp") and _div(shape[1], mesh, "model"):
            return P(dp if _div(shape[0], mesh, dp) else None, "model", None)
        return P(dp if _div(shape[0], mesh, dp) else None, None, None)
    if kind == "logits":
        return P(dp if _div(shape[0], mesh, dp) else None, None,
                 "model" if _div(shape[-1], mesh, "model") else None)
    if kind == "moe":
        return P("model" if _div(shape[0], mesh, "model") else None,
                 "data" if _div(shape[1], mesh, "data") else None, None)
    if kind == "moe_tokens":       # [G, T_local, d] grouped token stream
        return P("data" if _div(shape[0], mesh, "data") else None,
                 None, None)
    if kind == "moe_buf":          # [G, E, C, d] grouped expert buffer
        return P("data" if _div(shape[0], mesh, "data") else None,
                 "model" if _div(shape[1], mesh, "model") else None,
                 None, None)
    if kind == "attn_q":           # [B, S, H, hd]: seq over "model" (SP)
        if not ctx.get("attn_sp") or not _div(shape[1], mesh, "model"):
            return None
        return P(dp if _div(shape[0], mesh, dp) else None, "model",
                 None, None)
    raise ValueError(kind)


def shard_act(x, kind: str):
    """Redistribute a DTensor activation to the standard layout of
    ``kind``; ``x`` itself outside a context or for a plain tensor.

    kinds: "hidden" [B,S,D] - batch over DP (seq over "data" if seq_sharded)
           "logits" [B,S,V] - batch over DP, vocab over "model"
           "moe"    [E,C,D] - experts over "model", capacity over "data"
           "moe_tokens"/"moe_buf" - grouped dispatch (see moe_group_count)
           "attn_q" [B,S,H,hd] - context-parallel queries (opt-in)
    """
    ctx = _ACT_CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = act_spec(tuple(x.shape), kind, ctx)
    if spec is None:
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def cache_spec(mesh, batch: int, seq_sharded: bool) -> P:
    """KV-cache spec [B, S, kv, hd]: batch over DP (decode_32k), or for
    long_500k (B = 1) the sequence over "data"."""
    if seq_sharded:
        return P(None, "data", "model")
    return P(_dp(mesh), None, "model")
