"""Logical-axis sharding rules on DTensor, the port of
``repro/dist/sharding.py``.

A parameter carries a *spec*: one logical axis name per dimension, in the
port tensor's own dimension order (``models.param_specs``).  A *rules*
dict maps logical names to mesh dimensions; ``resolve_rules`` filters it
against the actual ``DeviceMesh`` (absent and size-1 dimensions drop out),
so the same model code runs on one device, where everything is
replicated, and on a production mesh of 16 x 16.

``pspec_for`` turns a spec into DTensor placements, one per mesh
dimension: ``Shard(d)`` where tensor dimension d maps to that mesh
dimension, ``Replicate()`` otherwise.  A tuple value such as
``("pod", "data")`` shards one tensor dimension over both, the first
named the major one (DTensor shards over the mesh dimensions in order, as
``PartitionSpec(("pod", "data"))`` does).  JAX pads an uneven shard;
DTensor makes the last shards smaller (``torch.chunk``'s split), so
memory is reckoned from the largest local shard (rank 0's).

``constrain`` is the one choke point the models call on activations.
Outside an ``activation_context``, or on a plain tensor, it is the
identity, which keeps every single-device path as it was, bit for bit;
inside one, on a DTensor, it redistributes to the rule's placements (the
reference's ``with_sharding_constraint``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import Placement

# Logical-name defaults, the reference's.  Params: shard the "wide" dims
# over model; keep the embedding dim replicated (row-parallel
# activations).  Activations: batch over data, heads/ff/vocab over model.
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    # param dims
    "embed": None,
    "ff": "model",
    "heads_dim": "model",
    "kv_dim": "model",
    "vocab": "model",
    "experts": "model",
    "lru": "model",
    "inner": "model",
    "inner_all": "model",
    # activation dims
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_ff": "model",
    "act_heads": "model",
    "act_vocab": "model",
    "act_experts": "model",
}


class Rules(dict):
    """Resolved rules (logical name -> mesh dimension name, a tuple of
    them, or None) that also know the mesh's dimension names in order
    (``axes``), which placements are laid out by."""

    def __init__(self, rules: dict, axes: tuple[str, ...]):
        super().__init__(rules)
        self.axes = tuple(axes)


def mesh_shape(mesh) -> dict[str, int]:
    """Mesh dimension name -> size.  A ``DeviceMesh``, or any object with
    a ``shape`` mapping (the reference's mesh, a stand-in)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _filter_axes(v, shape: dict[str, int]):
    """Drop mesh dimensions that don't exist (or are trivial) on this mesh."""
    if v is None:
        return None
    if isinstance(v, (list, tuple)):
        kept = tuple(a for a in v if shape.get(a, 1) > 1)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return v if shape.get(v, 1) > 1 else None


def resolve_rules(mesh, override=None) -> Rules:
    """DEFAULT_RULES (+ overrides, e.g. from --rules JSON) valid on ``mesh``."""
    rules = dict(DEFAULT_RULES)
    if override:
        rules.update(override)
    shape = mesh_shape(mesh)
    return Rules({k: _filter_axes(v, shape) for k, v in rules.items()}, tuple(shape))


def _mesh_axes(value) -> tuple[str, ...]:
    if value is None:
        return ()
    return tuple(value) if isinstance(value, (list, tuple)) else (value,)


def pspec_for(spec, rules: Rules, axes: tuple[str, ...] | None = None) -> tuple[Placement, ...]:
    """One spec tuple -> one placement per mesh dimension (``axes``, by
    default the resolved rules' own) under resolved rules.

    A mesh dimension shards at most one tensor dimension: where two names
    of a spec map to it (the MoE's ``("experts", "ff", "embed")``, both on
    ``model``), the first keeps it and the later one is replicated, as
    flax's ``logical_to_mesh_axes`` resolves it (JAX's ``NamedSharding``
    refuses a ``PartitionSpec`` that repeats an axis)."""
    axes = rules.axes if axes is None else tuple(axes)
    where: dict[str, int] = {}
    for dim, name in enumerate(spec):
        for axis in _mesh_axes(rules.get(name) if name is not None else None):
            where.setdefault(axis, dim)
    return tuple(Shard(where[a]) if a in where else Replicate() for a in axes)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A tensor's placements on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    placements: tuple[Placement, ...]

    def place(self, t: torch.Tensor) -> DTensor:
        """``t`` (the whole tensor, equal on every rank) as a DTensor here;
        a DTensor is redistributed."""
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements)
        return distribute_tensor(t, self.mesh, self.placements)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(s is None or isinstance(s, str) for s in x)


def _tree_map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def tree_shardings(specs, mesh, rules: Rules):
    """Spec tree (name -> spec, nested dicts allowed) -> NamedSharding tree."""
    return _tree_map(lambda spec: NamedSharding(mesh, pspec_for(spec, rules)), specs, _is_spec)


def distribute(tree, shardings):
    """Place every tensor of a nested dict by the NamedSharding at the same
    key (``shardings`` mirrors ``tree``)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    return shardings.place(tree) if isinstance(tree, torch.Tensor) else tree


def distribute_module(module: torch.nn.Module, shardings: dict[str, NamedSharding]) -> torch.nn.Module:
    """Replace every parameter of ``module`` (name -> its sharding, in
    ``named_parameters`` order) by a DTensor parameter in place."""
    for name, param in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, torch.nn.Parameter(shardings[name].place(param.detach()),
                                              requires_grad=param.requires_grad))
    return module


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextlib.contextmanager
def activation_context(mesh, rules: Rules):
    """Within this context, ``constrain`` redistributes DTensor activations,
    and a plain tensor that meets a DTensor in an op (the positions, masks
    and accumulators the models make) counts as replicated
    (``implicit_replication``): the sharded train step runs in one."""
    prev = getattr(_CTX, "value", None)
    _CTX.value = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.value = prev


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements`` in the forward and the gradient to
    the same placements in the backward: the transpose of a sharding
    constraint is the same constraint (JAX's rule), where DTensor's own
    ``redistribute`` would send the gradient back to the input's
    placements, and the backward's products would then pick their own."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements), None, None


def _even(shape, placements, mesh) -> tuple[Placement, ...]:
    """``placements`` with every shard of a dimension its mesh dimensions
    do not divide replaced by a replica (JAX pads such a shard; DTensor's
    views refuse one: a decode batch of 1 over 32 ranks)."""
    ways = {}
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(i)
    return tuple(Replicate() if isinstance(p, Shard) and shape[p.dim] % ways[p.dim] else p for p in placements)


def constrain(x, names):
    """Constrain activation ``x`` to the logical axes ``names`` (or no-op:
    outside a context, on a plain tensor, or on a rank mismatch), its
    gradient too.  A dimension its mesh dimensions do not divide stays
    replicated."""
    ctx = getattr(_CTX, "value", None)
    if ctx is None or not isinstance(x, DTensor) or x.ndim != len(names):
        return x
    mesh, rules = ctx
    return _Constrain.apply(x, mesh, _even(x.shape, pspec_for(names, rules), mesh))


def _reshape_groups(src, dst) -> list[tuple[list[int], list[int]]]:
    """The dimensions of a reshape in groups of equal products:
    (source dims, destination dims) each, in order."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        si, sj, pa, pb = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                si.append(i)
                pa *= src[i]
                i += 1
            else:
                sj.append(j)
                pb *= dst[j]
                j += 1
        groups.append((si, sj))
    if groups:  # trailing size-1 dims join the last group
        groups[-1][0].extend(range(i, len(src)))
        groups[-1][1].extend(range(j, len(dst)))
    return groups


def _reshape_placements(x: DTensor, shape) -> list[Placement]:
    """``x``'s placements with every shard a reshape to ``shape`` cannot
    keep evenly replicated: a shard survives an unchanged dimension, the
    first of a split whose size its mesh dimensions divide, and the first
    of a merge whose size they divide (DTensor refuses an uneven split and
    strides a shard of a later merged dimension)."""
    mesh = x.device_mesh
    groups = _reshape_groups(tuple(x.shape), tuple(shape))
    out = list(x.placements)
    for i, p in enumerate(x.placements):
        if not isinstance(p, Shard):
            continue
        ways = math.prod(mesh.size(k) for k, q in enumerate(x.placements) if isinstance(q, Shard) and q.dim == p.dim)
        si, sj = next(g for g in groups if p.dim in g[0])
        if type(p) is not Shard:  # a strided shard
            keep = False
        elif len(si) == 1:
            keep = shape[sj[0]] % ways == 0
        else:
            keep = len(sj) == 1 and si[0] == p.dim and x.shape[p.dim] % ways == 0
        if not keep:
            out[i] = Replicate()
    return out


def _reshape(x: DTensor, shape) -> DTensor:
    placements = _reshape_placements(x, shape)
    if placements != list(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward reshapes the gradient the same way:
    the gradient of a merge of heads is a split that DTensor would refuse
    on an uneven shard."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape(g, ctx.in_shape), None


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)``, which on a DTensor first replicates the mesh
    dimensions whose shard the reshape cannot keep evenly (an all-gather of
    the activation; GSPMD reshards on its own, DTensor refuses), forward
    and backward.  A plain tensor is reshaped as it is."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    shape = list(shape)
    if -1 in shape:
        shape[shape.index(-1)] = x.numel() // -math.prod(shape)
    return _Reshape.apply(x, tuple(shape))


def unflatten(x: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """``x.unflatten(dim, sizes)`` (a projection split into heads) through
    ``reshape``."""
    dim = dim % x.ndim
    return reshape(x, (*x.shape[:dim], *sizes, *x.shape[dim + 1:]))


def rowwise(fn, rows: tuple, whole: tuple = (), dims: tuple[int, ...] = (0,)):
    """``fn(*rows, *whole)`` for a computation independent along ``dims``
    of ``rows`` (the batch, dim 0; griffin's scan also its channels):
    where any is a DTensor, each rank runs ``fn`` on plain tensors, its own
    shard of ``rows`` (split over the mesh dimensions that shard any of
    them on one of ``dims``, whole elsewhere) and ``whole`` whole (their
    gradients ``Partial`` over the ranks that split the rows), and the
    outputs, whose ``dims`` are the rows', come back split alike.  DTensor
    would dispatch every op of a long loop (the SSD's chunk recurrence, the
    scan's levels), and on a 3-dimensional mesh its sharding search for
    some of them takes minutes; a rank's values are the unsharded
    computation's."""
    tensors = [t for t in rows if isinstance(t, DTensor)]
    if not tensors:
        return fn(*rows, *whole)
    mesh = tensors[0].device_mesh
    split = {}
    for t in tensors:
        for i, p in enumerate(t.placements):
            if type(p) is Shard and p.dim in dims:
                split.setdefault(i, p.dim)
    placed = [Shard(split[i]) if i in split else Replicate() for i in range(mesh.ndim)]
    local = [t.redistribute(mesh, placed).to_local() if isinstance(t, DTensor)
             else distribute_tensor(t, mesh, placed).to_local() for t in rows]
    # a whole tensor's gradient from each rank's rows is a part of the sum
    partial = [Partial() if i in split else Replicate() for i in range(mesh.ndim)]
    local += [t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=partial)
              if isinstance(t, DTensor) else t for t in whole]
    out = fn(*local)
    sizes = {d: rows[0].shape[d] for d in dims}

    def back(t):  # the global shape's contiguous strides: the local tensor made contiguous too
        shape = tuple(sizes.get(d, n) for d, n in enumerate(t.shape))
        return DTensor.from_local(t.contiguous(), mesh, placed, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    return tuple(back(t) for t in out) if isinstance(out, tuple) else back(out)


def index_add_rows(n: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``zeros((n, d)).index_add_(0, index.reshape(-1), src.reshape(-1, d))``
    for ``src`` (E, C, d) and ``index`` (E, C): the MoE's combine of each
    expert's outputs back into the token rows.

    DTensor's own rule for ``index_add_`` breaks on a ``src`` sharded over
    its experts, so on a DTensor each rank adds the rows of its own experts
    (``src``'s shard of dim 0 kept, the rest replicated) into a local
    (n, d) and the result is ``Partial`` over the mesh dimensions that
    shard the experts: their sum, reduced where the caller next places it.
    """
    d = src.shape[-1]
    if not isinstance(src, DTensor):
        out = torch.zeros((n, d), dtype=src.dtype, device=src.device)
        return out.index_add_(0, index.reshape(-1), src.reshape(-1, d))
    mesh = src.device_mesh
    placements = [p if type(p) is Shard and p.dim == 0 else Replicate() for p in src.placements]
    src = src.redistribute(mesh, placements)
    local = src.to_local()
    _, offset = compute_local_shape_and_global_offset(src.shape, mesh, placements)
    index = index.full_tensor() if isinstance(index, DTensor) else index
    index = index[offset[0]:offset[0] + local.shape[0]]
    out = torch.zeros((n, d), dtype=local.dtype, device=local.device)
    out = out.index_add_(0, index.reshape(-1), local.reshape(-1, d))
    partial = [Partial() if isinstance(p, Shard) else Replicate() for p in placements]
    return DTensor.from_local(out, mesh, partial, run_check=False)


# ---------------------------------------------------------------------------
# launcher / dry-run sharding factories
# ---------------------------------------------------------------------------


def _batch_axes(mesh):
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if shape.get(a, 1) > 1)
    return axes, math.prod(shape[a] for a in axes)


def _shard_dim(mesh, dim: int, axes) -> tuple[Placement, ...]:
    return tuple(Shard(dim) if a in axes else Replicate() for a in mesh_shape(mesh))


def batch_shardings(batch, mesh):
    """Shard the leading (global-batch) dim of every batch tensor over data
    (and pod), where it divides; replicate the rest."""
    axes, size = _batch_axes(mesh)

    def one(t):
        if axes and t.ndim >= 1 and t.shape[0] % size == 0:
            return NamedSharding(mesh, _shard_dim(mesh, 0, axes))
        return NamedSharding(mesh, _shard_dim(mesh, 0, ()))

    return _tree_map(one, batch, lambda x: not isinstance(x, dict))


def cache_shardings(cache, mesh):
    """Decode caches are laid out (layers, batch, ...): shard dim 1 over
    data where it divides; replicate the rest (``pos`` included)."""
    axes, size = _batch_axes(mesh)

    def one(t):
        if axes and getattr(t, "ndim", 0) >= 2 and t.shape[1] % size == 0:
            return NamedSharding(mesh, _shard_dim(mesh, 1, axes))
        return NamedSharding(mesh, _shard_dim(mesh, 0, ()))

    return _tree_map(one, cache, lambda x: not isinstance(x, dict))


def _transposed(placements) -> tuple[Placement, ...]:
    """Placements of a 2-D tensor's transpose."""
    return tuple(Shard(1 - p.dim) if isinstance(p, Shard) else p for p in placements)


def opt_state_shardings(p_shard: dict[str, NamedSharding], opt_state: dict, mesh, layouts: dict[str, bool]):
    """Optimizer-state shardings mirroring the parameter shardings
    (``p_shard``: name -> NamedSharding), the reference's rules:

      * a moment (AdamW's ``m``/``v``) with its parameter's shape is placed
        like the parameter;
      * an int8 state's ``q`` is placed like its parameter and its
        ``scale`` is replicated;
      * factored (Adafactor) states, odd-shaped states and scalars
        (``step``) are replicated.

    The port keeps an int8 state in the layout of the reference's slice,
    the transpose of an ``nn.Linear`` weight: ``layouts`` (name -> True
    where the state is transposed against its parameter) says where.
    """
    repl = NamedSharding(mesh, _shard_dim(mesh, 0, ()))

    def per_state(tree):
        if not isinstance(tree, dict) or set(tree) != set(p_shard):
            return _tree_map(lambda _: repl, tree, lambda x: not isinstance(x, dict))
        out = {}
        for name, sub in tree.items():
            sh = p_shard[name]
            if isinstance(sub, dict) and set(sub) == {"q", "scale"}:
                q = _transposed(sh.placements) if layouts[name] else sh.placements
                out[name] = {"q": NamedSharding(mesh, q), "scale": repl}
            elif isinstance(sub, torch.Tensor):
                out[name] = sh
            else:
                out[name] = _tree_map(lambda _: repl, sub, lambda x: not isinstance(x, dict))
        return out

    return {k: repl if isinstance(v, torch.Tensor) else per_state(v) for k, v in opt_state.items()}


__all__ = [
    "DEFAULT_RULES", "NamedSharding", "Rules", "activation_context", "batch_shardings", "cache_shardings",
    "constrain", "distribute", "distribute_module", "index_add_rows", "mesh_shape",
    "opt_state_shardings", "pspec_for", "reshape", "rowwise", "resolve_rules", "tree_shardings", "unflatten",
]
