"""Logical-axis sharding on the port's mesh. The port of
`repro.models.sharding`.

Every parameter dimension has a *logical* name; `AXIS_RULES` maps it to
axes of the production mesh ('pod', 'data', 'model'). `spec(*logical)`
gives the `P` of those names on the active mesh (`use_mesh`), dropping
the axes that mesh lacks, so one spec tree serves every mesh.

The mesh is `core.distributed.Mesh`: an ordered tuple of torch devices
over named axes, driven from one process, repeats allowed. Where the
reference leaves placement to XLA, the port places a tensor itself:

  * `Placed`: a tensor laid out over a mesh by a `P`, one local tensor
    per mesh entry on that entry's device, sliced along each dimension
    whose entry names mesh axes (the block of the entry's coordinates on
    those axes, the first axis major; blocks of ⌈n / parts⌉ rows, the
    last ones shorter, as XLA pads), whole where the entry is None.
    `place(x, mesh, p)` is the counterpart of
    `jax.device_put(x, NamedSharding(mesh, p))`; `.full()` gathers it,
    `.load_(x)` fills it. Entries of one device that hold the same block
    share one local tensor; one already on its entry's device is a view
    of the input unless `own` asks for a copy. A Placed value is a
    pytree node whose children are its local tensors.
  * `param_specs(model)`: each parameter name of the port's `LM` to the
    `P` of its logical axes, the specs `LM.init` returns in the
    reference, with the `scan` layout's leading `stack` axis dropped
    (the port's leaves are per layer).

`shard` returns its input: placement constraints are XLA's, and the
port's eager model has nothing to constrain. `fsdp_use` is FSDP's
gather (below).

Tensor parallelism on 'model'. Where the reference's partitioner turns
these specs into a program, the port writes it out. A mesh *entry* is
one ('data', 'model') coordinate; the entries of one data coordinate
(`model_entries`, an `Entries`) share that data shard's rows, and each
computes on the blocks of the leaves that its 'model' coordinate holds
by `param_specs` (heads, kv heads where they shard, MLP columns,
experts, vocab), read through `Entry.take`. One process drives every
entry of a data shard, one after another, inside each layer; the
layers read the entries from the caller (`use_entries`), and the train
and serving steps set them per data shard. Only the GQA families
(dense, MoE, the encoder) shard (`tp_family`); MLA and SSM layers keep
the whole leaves, and only the first entry of each data coordinate
works for them.

The state is laid out as the reference lays it out over 'model'.
`place_model(model, mesh)` makes each leaf whose spec puts a dimension
on 'model' (`model_dim`) a Placed value of the model (`leaf_spec`: that
dimension on 'model', the rest whole): each entry holds its `tp_block`
on its device as a tensor of its own, and no device holds the whole
leaf. The other leaves (norms, router, frontend, whole wk / wv) stay
whole Parameters on the mesh's first device, the data shards' root.
`named_leaves(model)` lists both kinds in the parameter order (a placed
leaf is no longer in `named_parameters`), `gather_model` undoes the
placement, and `Entry.take` reads a view of the entry's own block (mesh
entry `Entry.index`), or cuts and moves a whole leaf. The train step
(`train/train_step.py`) and the serving steps lay the model out for
their mesh (`lay_out_model`: placed on a mesh whose 'model' axis the
config shards over, gathered otherwise); checkpoints gather the blocks
(`Placed.full`). The dry-run traces entry 0 alone: `entry_model` is
`place_model` for that one entry (`traced_entry`), so the traced state
holds what entry 0 of a real mesh holds.

The partial results meet in `model_sum`: the entries' partials summed
in mesh order in float32 and cast once to the activation dtype (no
atomics, so two runs are bit-equal). With bf16 activations the
row-parallel products hand it float32 partials (`partial_product`; the
MoE combine adds its pairs in float32), so the sum rounds once, as the
unsharded product does; the dry-run counts those float32 bytes. It goes
through the `torch.ops.repro_torch`
operator `model_allreduce` (CPU and CUDA: the sum; a fake for meta
tensors), as an autograd function whose backward hands each entry the
output's gradient. A sharded region's replicated input goes to the
entries through `model_copy`, whose backward sums their gradients of it
through the same operator: the gradient's all-reduce (Megatron's f and
g). In the dry-run's trace of one entry alone (`entry_model`,
`traced_entry`) the operator returns the entry's partial, and
`launch/graph_analysis.py` records each call as a ring all-reduce,
2·(tp−1)/tp of the tensor per entry, by kind (":bwd" for a gradient's).
`model_max` (the CE's max) and `model_gather` (serving's logits: the
vocab blocks in order) are the other two collectives. In training each
column-parallel product (q, k, v, the MLP's wi and wg, the logits) takes
a float32 carrier of its replicated input (`model_copy(..., wide=True)`,
`column_product`): its input gradient stays float32 per entry, and
`model_copy`'s all-reduce rounds the sum once, as the unsharded
product's backward rounds it (the MoE experts' inputs keep bf16 parts).

FSDP over the batch axes. `place_model(model, mesh, specs=)` lays each
leaf out by its spec in a tree such as `param_specs(model)` under
`use_mesh` (the reference's `make_train_state_specs`): the 'embed'
dimension on 'data' and the 'model' blocks (dropped for a family that
does not shard over 'model', `layout_spec`), so each entry holds its
('data', 'model') block of the leaf, and no two entries one block
(`is_fsdp`). The layout is the caller's choice, recorded on the model
(`placed_specs`) and kept by `lay_out_model` on its mesh. A layer reads
its leaves through `fsdp_layer` / `fsdp_use`, inside its remat region
(`models/model.Block.run`): each FSDP leaf's blocks along the batch axes
are gathered in mesh order (`gather_sources`) onto the data shard's
entries, cast first to the activation dtype (the use site's cast, so
half the bytes and the same bits), by the `torch.ops.repro_torch`
operator `data_allgather` (a fake for meta tensors: the traced entry's
gather has the whole shape). Its backward (`data_reducescatter`) hands
each block its slice of the gradient in the block's dtype; the train
step sums the data shards' slices of a block in mesh order on the entry
that holds it (the reduce-scatter, with no atomics). The data shard a
model entry point runs for is `use_shard`'s (the train and serving
steps set it; `current_shard`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.distributed import Mesh
from repro_torch.kernels import oplib
from repro_torch.launch.mesh import canon_device

Axes = Union[str, None, Tuple[Union[str, None], ...]]

AXIS_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",        # FSDP shard dim of params
    "embed_tp": "model",    # opt: d_model of the lookup table on 'model'
    "act_embed": None,      # activations keep d_model replicated
    "heads": "model",
    "kv_heads": "model",    # only where divisible by 16 (see below)
    "kv_heads_rep": None,   # non-divisible kv heads: replicate
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "vocab": "model",
    "ssm_heads": "model",
    "ssm_heads_rep": None,
    "ssm_inner": "model",
    "state": None,
    "conv": None,
    "lora": None,
    "stack": None,          # scan-stacked layer axis
    "cache_seq": None,
    "frame": None,
}

_state = threading.local()

# Beyond-paper optimisation toggles of the reference; default off. Of
# them only 'embed_dshard' changes a spec here: the port refuses the fused
# weights of 'fused_qkv', and 'fsdp_gather_weights' is an XLA constraint.
OPTIMIZATIONS = set()


def opt_enabled(name: str) -> bool:
    return name in OPTIMIZATIONS


class P(tuple):
    """A partition spec: per dimension None, one mesh axis name, or a
    tuple of names (the first major). A tuple of one name is that name,
    as in JAX's PartitionSpec."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` the active mesh of this thread for the block."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def keep_axes(p: Sequence, names: Optional[set]) -> P:
    """`p` with the mesh axes outside `names` dropped (None: keep all); an
    entry left with no axis becomes None."""
    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if names is None or a in names)
            return kept if kept else None
        return entry if names is None or entry in names else None

    return P(*[fix(e) for e in p])


def spec(*logical: Axes) -> P:
    """The `P` of logical dimension names by AXIS_RULES, with the mesh
    axes absent from the active mesh dropped."""
    mesh = current_mesh()
    names = set(mesh.axis_names) if mesh is not None else None
    return keep_axes([None if name is None else AXIS_RULES.get(name)
                      for name in logical], names)


def shard(x: torch.Tensor, *logical: Axes) -> torch.Tensor:
    """The reference's with_sharding_constraint: x unchanged."""
    return x


def fsdp_use(w, *logical: Axes, dtype: Optional[torch.dtype] = None,
             entries: Optional["Entries"] = None,
             shard: Optional[int] = None):
    """The reference's gathered-weight constraint. A leaf laid out over
    batch axes (`is_fsdp`: a `place_model(..., specs=)` leaf) comes back
    as the current data shard reads it: its blocks along those axes
    gathered in mesh order (`data_allgather`, differentiable), cast to
    `dtype` first where given (the use site's cast, so the gather moves
    the activation dtype's bytes). Where the leaf's spec still names
    'model', a Placed value of its 'model' layout holding, for each of
    `entries` (default: the current ones), the block that entry's
    'model' coordinate holds, on its device, which `Entry.take` narrows;
    otherwise the whole leaf on the data shard's root device (`shard`,
    a mesh entry; default: the first of `entries`, else
    `current_shard()`). Any other leaf comes back unchanged."""
    if not is_fsdp(w):
        return w
    entries = current_entries() if entries is None else entries
    targets = gather_targets(w, entries, shard)
    rest = drop_batch_axes(w.spec)
    if not any(rest):
        return data_gather(w, targets[0], dtype)
    shards: List[Optional[torch.Tensor]] = [None] * len(w.shards)
    for j in targets:
        shards[j] = data_gather(w, j, dtype)
    return Placed(shards, w.mesh, rest, w.shape)


def gather_targets(w, entries=None, shard: Optional[int] = None
                   ) -> List[int]:
    """The mesh entries that a data shard gathers the FSDP leaf `w` for
    (`fsdp_use`): each of its 'model' `entries` where w's spec names
    'model', else its root: `shard`, or the first of `entries`, or
    `current_shard()`."""
    if any(drop_batch_axes(w.spec)):
        if not entries or entries.indices is None:
            raise ValueError(f"{w!r}: its 'model' blocks are read under the "
                             f"mesh's entries (use_entries)")
        return list(entries.indices)
    if shard is None:
        shard = (entries.indices[0] if entries and entries.indices
                 else current_shard())
    return [shard]


def fsdp_layer(params, dtype: torch.dtype,
               entries: Optional["Entries"] = None,
               shard: Optional[int] = None):
    """A layer's leaves (a dict or ParameterDict) as the data shard reads
    them: `params` itself where no leaf is laid out over batch axes,
    else a dict with each such leaf gathered (`fsdp_use`, in `dtype`,
    the activation dtype every such leaf is cast to at its use)."""
    if not any(is_fsdp(v) for v in params.values()):
        return params
    return {k: fsdp_use(v, dtype=dtype, entries=entries, shard=shard)
            for k, v in params.items()}


def current_shard() -> int:
    """The mesh entry of the data shard whose loss or serving step runs
    (`use_shard`; 0, the first, by default: the dry-run's traced
    entry)."""
    return getattr(_state, "shard", 0)


@contextlib.contextmanager
def use_shard(index: Optional[int]):
    """Make mesh entry `index` the root of the data shard that the
    model's entry points run for in the block (where FSDP leaves are
    gathered for it)."""
    prev = current_shard()
    _state.shard = 0 if index is None else index
    try:
        yield
    finally:
        _state.shard = prev


# ------------------------- placed values -------------------------
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def block_slices(shape: Sequence[int], p: Sequence, sizes: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of the block that a mesh entry at `coords` (axis ->
    index) holds of a tensor of `shape` laid out by `p` over a mesh of
    `sizes` (axis -> extent)."""
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(p[d]) if d < len(p) else ()
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        step = -(-n // parts)
        out.append(slice(min(idx * step, n), min((idx + 1) * step, n)))
    return tuple(out)


def _check_spec(p: Sequence, ndim: int, mesh: Mesh) -> P:
    p = P(*p)
    if len(p) > ndim:
        raise ValueError(f"spec {p} has more entries than the {ndim} "
                         f"dimensions of the value")
    used = [a for e in p for a in _entry_axes(e)]
    for a in used:
        if a not in mesh.axis_names:
            raise ValueError(f"spec {p} names axis {a!r}, which the mesh "
                             f"{mesh.axis_names} lacks")
    if len(set(used)) != len(used):
        raise ValueError(f"spec {p} uses a mesh axis twice")
    return p


def entry_coords(mesh: Mesh, j: int) -> Dict[str, int]:
    """Mesh entry j's index on each axis (the entries are row-major)."""
    return dict(zip(mesh.axis_names,
                    (int(c) for c in np.unravel_index(j, mesh.axis_sizes))))


class Placed:
    """A tensor laid out over a mesh by a `P` (see the module docstring):
    `shards[j]` is mesh entry j's block, on `mesh.devices[j]`, or None
    where the value was placed for some entries only (`place(...,
    only=)`). Entries of one device that hold the same block share one
    tensor."""

    def __init__(self, shards: Sequence[Optional[torch.Tensor]], mesh: Mesh,
                 p: P, shape: Tuple[int, ...]):
        self.shards = tuple(shards)
        self.mesh = mesh
        self.spec = p
        self.shape = tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.distinct()[0][1].dtype

    def block(self, j: int) -> Tuple[slice, ...]:
        """The slices of the whole tensor that entry j holds."""
        return block_slices(self.shape, self.spec, self.mesh.shape,
                            entry_coords(self.mesh, j))

    def block_key(self, j: int) -> Tuple[Tuple[int, int], ...]:
        return tuple((s.start, s.stop) for s in self.block(j))

    def distinct(self) -> List[Tuple[int, torch.Tensor]]:
        """(the first entry that holds it, the tensor) of each distinct
        local tensor, in mesh order."""
        seen, out = set(), []
        for j, t in enumerate(self.shards):
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                out.append((j, t))
        return out

    def map(self, fn) -> "Placed":
        """A Placed value of `fn` of each distinct local tensor, shared by
        the same entries."""
        made = {id(t): fn(t) for _, t in self.distinct()}
        return Placed([None if t is None else made[id(t)]
                       for t in self.shards], self.mesh, self.spec,
                      self.shape)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor (a new one) on `device`, mesh entry 0's by
        default, from the first entry that holds each block."""
        dev = self.mesh.devices[0] if device is None else torch.device(
            device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen = set()
        for j, local in self.distinct():
            key = self.block_key(j)
            if key not in seen:
                seen.add(key)
                out[self.block(j)] = local.detach().to(dev)
        want = {self.block_key(j) for j in range(len(self.shards))}
        if seen != want:
            raise ValueError(f"{self!r} holds {len(seen)} of its "
                             f"{len(want)} blocks: it cannot be gathered")
        return out

    def load_(self, src) -> "Placed":
        """Copy `src` (a whole tensor or numpy array, or a Placed value of
        the same shape) into every local tensor's block, in place."""
        with torch.no_grad():
            if (isinstance(src, Placed) and src.mesh == self.mesh
                    and src.spec == self.spec and src.shape == self.shape
                    and all(src.shards[j] is not None
                            for j, _ in self.distinct())):
                for j, t in self.distinct():
                    t.copy_(src.shards[j])
                return self
            whole = (src.full() if isinstance(src, Placed)
                     else torch.as_tensor(src))
            if tuple(whole.shape) != self.shape:
                raise ValueError(f"a value of {tuple(whole.shape)} for "
                                 f"{self!r}")
            for j, t in self.distinct():
                t.copy_(whole[self.block(j)])
        return self

    def __repr__(self):
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.axis_names}"
                f"{self.mesh.axis_sizes})")


# a Placed value's local tensors are its pytree children, so that what
# walks a state's tensors (the dry-run's analyzer) sees the blocks
torch.utils._pytree.register_pytree_node(
    Placed, lambda x: (list(x.shards), (x.mesh, x.spec, x.shape)),
    lambda shards, ctx: Placed(list(shards), *ctx))


def local_tensors(x) -> List[torch.Tensor]:
    """The distinct tensors that hold a leaf: a Placed value's local
    tensors, or the tensor itself."""
    return ([t for _, t in x.distinct()] if isinstance(x, Placed)
            else [x])


def place(x, mesh: Mesh, p: Sequence = (), *, own: bool = False,
          only: Optional[Sequence[int]] = None,
          dtype: Optional[torch.dtype] = None) -> Placed:
    """`x` (a tensor, a numpy array or a Placed value) laid out over
    `mesh` by `p`: each entry's block on its device (in `dtype`, where
    given), one tensor per device and block. A block already on its
    device is a view of `x`, unless `own` asks for a copy (so that the
    whole of `x` can be freed). With `only` (mesh entry indices), the
    other entries hold None."""
    if isinstance(x, Placed):
        x = x.full()
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    p = _check_spec(p, t.dim(), mesh)
    made: Dict[tuple, torch.Tensor] = {}
    shards: List[Optional[torch.Tensor]] = []
    for j, dev in enumerate(mesh.devices):
        if only is not None and j not in only:
            shards.append(None)
            continue
        sl = block_slices(t.shape, p, mesh.shape, entry_coords(mesh, j))
        key = (canon_device(dev), tuple((s.start, s.stop) for s in sl))
        if key not in made:
            block = t[sl]
            made[key] = (block.detach().to(
                dev, dtype, copy=True, memory_format=torch.contiguous_format)
                if own else block.to(dev, dtype))
        shards.append(made[key])
    return Placed(shards, mesh, p, tuple(t.shape))


# ------------------------- parameter specs -------------------------
_LAYER = re.compile(r"^layers\.\d+\.(.+)$")


def _layer_axes(cfg, rest: str) -> Tuple[Axes, ...]:
    """The logical axes of a layer leaf `rest` ("attn.wq", "mlp.wo", ...):
    the reference's init_gqa / init_mla / init_ssm / init_mlp / init_moe
    and the norms of `_init_layer`."""
    part, leaf = rest.split(".", 1) if "." in rest else ("", rest)
    if not part:        # attn_norm, ssm_norm, mlp_norm
        return ("act_embed",)
    if part == "attn" and cfg.attn_type == "mla":
        return {"q_a": ("embed", "lora"), "q_a_norm": ("lora",),
                "q_b": ("lora", "heads", None),
                "kv_a": ("embed", "lora"), "kv_a_norm": ("lora",),
                "kv_b": ("lora", "heads", None),
                "wo": ("heads", None, "embed")}[leaf]
    if part == "attn":
        kv = "kv_heads" if cfg.n_kv_heads % 16 == 0 else "kv_heads_rep"
        return {"wq": ("embed", "heads", "head_dim"),
                "wk": ("embed", kv, "head_dim"),
                "wv": ("embed", kv, "head_dim"),
                "wo": ("heads", "head_dim", "embed")}[leaf]
    if part == "ssm":
        whole = cfg.ssm_nheads % 16 == 0
        h = "ssm_heads" if whole else "ssm_heads_rep"
        inner = "ssm_inner" if whole else None
        return {"in_proj": ("embed", inner), "conv_w": ("conv", None),
                "conv_b": (None,), "A_log": (h,), "D": (h,),
                "dt_bias": (h,), "norm": (None,),
                "out_proj": (inner, "embed")}[leaf]
    if part == "mlp" and cfg.is_moe:
        return {"router": ("embed", None),
                "wi": ("experts", "embed", "expert_mlp"),
                "wg": ("experts", "embed", "expert_mlp"),
                "wo": ("experts", "expert_mlp", "embed")}[leaf]
    if part == "mlp":
        return {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
                "wo": ("mlp", "embed")}[leaf]
    raise KeyError(rest)


def param_axes(cfg, name: str) -> Tuple[Axes, ...]:
    """The logical axes of the port's parameter `name` under `cfg`."""
    m = _LAYER.match(name)
    if m:
        return _layer_axes(cfg, m.group(1))
    if name == "embedding":
        return ((None, "embed_tp") if opt_enabled("embed_dshard")
                else ("vocab", "embed"))
    return {"lm_head": ("vocab", "embed"), "final_norm": ("act_embed",),
            "frontend.proj": ("frame", "embed")}[name]


def param_specs(model) -> Dict[str, P]:
    """{parameter name: its P on the active mesh} of a port `LM`."""
    return {name: spec(*param_axes(model.cfg, name))
            for name, _ in named_leaves(model)}


# ------------------------- tensor parallelism on 'model' -------------------------
def tp_block(n: int, tp: int, coord: int) -> slice:
    """The block of a dimension of n that 'model' coordinate `coord` of
    `tp` holds: `block_slices`' rule (blocks of ⌈n / tp⌉, the last ones
    shorter, as XLA pads)."""
    step = -(-n // tp)
    return slice(min(coord * step, n), min((coord + 1) * step, n))


def tp_family(cfg) -> bool:
    """Whether `cfg`'s layers shard over 'model' in the port: the GQA
    families (dense, MoE, the encoder). MLA and SSM layers keep whole
    leaves."""
    return cfg.attn_type == "gqa" and not cfg.has_ssm


def kv_shards(cfg) -> bool:
    """The reference's rule: kv heads go to 'model' only where
    `n_kv_heads % 16 == 0` (fixed at 16 whatever the mesh)."""
    return cfg.n_kv_heads % 16 == 0


def check_tp(cfg, tp: int) -> None:
    """Raise ValueError unless `cfg`'s heads, sharded kv heads and experts
    divide by `tp` (the vocab and d_ff take `tp_block`'s uneven blocks)."""
    bad = []
    if cfg.n_heads % tp:
        bad.append(f"{cfg.n_heads} heads")
    if kv_shards(cfg) and cfg.n_kv_heads % tp:
        bad.append(f"{cfg.n_kv_heads} kv heads")
    if cfg.is_moe and cfg.n_experts % tp:
        bad.append(f"{cfg.n_experts} experts")
    if bad:
        raise ValueError(f"{cfg.name}: {', '.join(bad)} do not divide by the "
                         f"'model' extent {tp}; pad the config with "
                         f"ArchConfig.padded_for_mesh({tp})")
    if opt_enabled("embed_dshard"):
        raise ValueError("'embed_dshard' puts d_model of the table on "
                         "'model'; the port's tensor-parallel path shards "
                         "it by vocab")


@dataclasses.dataclass(frozen=True)
class Entry:
    """One 'model' coordinate of `tp`, on `device`: mesh entry `index`
    (None for entries made without a mesh, which read whole leaves
    only)."""

    tp: int
    coord: int
    device: torch.device
    index: Optional[int] = None

    def block(self, n: int) -> slice:
        return tp_block(n, self.tp, self.coord)

    def take(self, w, dim: int, sl: slice, n: int) -> torch.Tensor:
        """The part `sl` (of a dimension of n) of the leaf `w` along `dim`.
        Of a placed leaf (a `Placed` value, `place_model`), a view of the
        block this entry holds, which must contain `sl`; of a whole
        tensor (a replicated leaf), the part cut and moved to this
        entry's device (a view where it is there already)."""
        if is_fsdp(w):      # a leaf read outside `fsdp_layer`
            w = fsdp_use(w, entries=Entries(self.tp, (self.coord,),
                                            (self.device,), (self.index,)))
        if isinstance(w, Placed):
            local = None if self.index is None else w.shards[self.index]
            held = None if local is None else w.block(self.index)[dim]
            if (local is None or w.shape[dim] != n
                    or canon_device(w.mesh.devices[self.index]) != self.device
                    or not held.start <= sl.start <= sl.stop <= held.stop):
                raise ValueError(
                    f"{w!r}: mesh entry {self.index} on {self.device} holds "
                    f"no block with {sl} of a dimension of {n}")
            return local.narrow(dim, sl.start - held.start,
                                sl.stop - sl.start)
        if w.shape[dim] != n:
            raise ValueError(f"a whole leaf of {w.shape[dim]} along dim {dim}"
                             f", not {n}")
        return w.narrow(dim, sl.start, sl.stop - sl.start).to(self.device)


@dataclasses.dataclass(frozen=True)
class Entries:
    """The 'model' entries that one data shard's forward drives, in mesh
    order: `coords` of a 'model' extent `tp` on `devices`, mesh entries
    `indices` (the blocks they read of a placed model). All `tp` of them
    on a real mesh; one in the dry-run's trace (`traced_entry`). The
    shard's replicated activations live on the first one's device."""

    tp: int
    coords: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    indices: Optional[Tuple[int, ...]] = None

    def __iter__(self) -> Iterator[Entry]:
        idx = self.indices or (None,) * len(self.coords)
        return (Entry(self.tp, c, d, j)
                for c, d, j in zip(self.coords, self.devices, idx))


def shards_over_model(mesh: Optional[Mesh], cfg) -> bool:
    """Whether `cfg`'s leaves shard over `mesh`'s 'model' axis: an extent
    above 1 and a family that shards (`tp_family`)."""
    return (mesh is not None and mesh.shape.get("model", 1) > 1
            and tp_family(cfg))


def model_entries(mesh: Optional[Mesh], at: Dict[str, int],
                  cfg) -> Optional[Entries]:
    """The 'model' entries of the data shard at coordinates `at` (axis ->
    index; axes absent are 0) of `mesh`, for `cfg`: None without a
    'model' axis of extent > 1 or for a family that does not shard
    (`tp_family`). Raises ValueError where `check_tp` does."""
    if not shards_over_model(mesh, cfg):
        return None
    tp = mesh.shape["model"]
    check_tp(cfg, tp)
    devs, idx = [], []
    for m in range(tp):
        c = dict(at, model=m)
        j = int(np.ravel_multi_index([c.get(a, 0) for a in mesh.axis_names],
                                     mesh.axis_sizes))
        devs.append(canon_device(mesh.devices[j]))
        idx.append(j)
    return Entries(tp, tuple(range(tp)), tuple(devs), tuple(idx))


def traced_entry(tp: int, device) -> Entries:
    """Entry 0 of a 'model' extent `tp` alone (the largest blocks), as the
    dry-run traces it: mesh entry 0 of `entry_model`'s placement."""
    return Entries(tp, (0,), (torch.device(device),), (0,))


def current_entries() -> Optional[Entries]:
    return getattr(_state, "entries", None)


@contextlib.contextmanager
def use_entries(entries: Optional[Entries]):
    """Make `entries` the 'model' entries that the model's entry points
    (`LM.loss_fn`, `prefill`, `decode_step`, `encode`, `forward`,
    `init_caches`) drive in the block."""
    prev = current_entries()
    _state.entries = entries
    try:
        yield
    finally:
        _state.entries = prev


def model_dim(cfg, name: str) -> Optional[int]:
    """The dimension of the leaf `name` that its spec puts on 'model', or
    None (replicated)."""
    for d, axis in enumerate(param_axes(cfg, name)):
        if axis is not None and "model" in _entry_axes(AXIS_RULES.get(axis)):
            return d
    return None


def leaf_spec(cfg, name: str, ndim: int) -> P:
    """The 'model' layout of the leaf `name` (`place_model`'s default):
    its `model_dim` on 'model', every other dimension whole. The 'data'
    axes of `param_specs` are FSDP's, which `place_model(..., specs=)`
    lays out too."""
    d = model_dim(cfg, name)
    return P(*[("model" if i == d else None) for i in range(ndim)])


def layout_spec(p: Sequence, mesh: Mesh, cfg) -> Optional[P]:
    """A leaf's spec `p` (of a spec tree, `param_specs`) as `place_model`
    lays it out on `mesh`: the axes the mesh lacks dropped, and 'model'
    too where `cfg` does not shard over the mesh's 'model' axis
    (`shards_over_model`: MLA, SSM and hybrid layers keep whole heads);
    None where no axis is left (a whole leaf)."""
    names = set(mesh.axis_names)
    if not shards_over_model(mesh, cfg):
        names.discard("model")
    p = keep_axes(p, names)
    return p if any(_entry_axes(e) for e in p) else None


def _owner(model, name: str):
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


def _get_leaf(model, name: str):
    """The leaf `name` of `model`: a Parameter, or a Placed value."""
    mod, leaf = _owner(model, name)
    return (mod[leaf] if isinstance(mod, torch.nn.ParameterDict)
            else getattr(mod, leaf))


def _set_leaf(model, name: str, value) -> None:
    mod, leaf = _owner(model, name)
    mod._parameters.pop(leaf, None)
    mod.__dict__.pop(leaf, None)
    if isinstance(mod, torch.nn.ParameterDict):
        mod[leaf] = value
    else:
        setattr(mod, leaf, value)


def placed_mesh(model) -> Optional[Mesh]:
    """The mesh `place_model` laid `model` out on, or None."""
    return getattr(model, "_placed_on", None)


def named_leaves(model) -> List[Tuple[str, object]]:
    """(name, leaf) of every parameter of `model` in `named_parameters`'
    order: a placed leaf as its Placed value (which `named_parameters`
    no longer yields), a replicated one as its Parameter."""
    names = getattr(model, "_leaf_names", None)
    if names is None:
        return list(model.named_parameters())
    return [(n, _get_leaf(model, n)) for n in names]


def place_model(model, mesh: Mesh, values: Optional[Dict] = None,
                only: Optional[Sequence[int]] = None,
                specs: Optional[Dict[str, P]] = None):
    """`model` (a port `LM`) laid out on `mesh`, in place, and returned.
    By default the 'model' layout: each leaf whose spec puts a dimension
    on 'model' (`model_dim`) becomes a Placed value (`leaf_spec`), each
    mesh entry holding its `tp_block` of it on its device as a tensor of
    its own (entries of one device share one per block); every other
    leaf stays a whole Parameter on the mesh's first device (its data
    shard's root). With `specs` ({name: P}, e.g. `param_specs(model)`
    under `use_mesh`), each leaf is laid out by its spec on the mesh
    (`layout_spec`): one that names a mesh axis becomes a Placed value,
    each entry its block on its device (FSDP where the spec names batch
    axes: `is_fsdp`); one that names none stays whole on the root. The
    layout is recorded (`placed_specs`). No reference to a whole sharded
    leaf is kept. The values are the model's own (a placed model is laid
    out anew), or `values` ({name: a whole tensor or array}), cut block
    by block. With `only` (mesh entry indices) the other entries hold
    nothing: `entry_model`. Parameter names and `named_leaves`' order
    stay the reference's."""
    cfg = model.cfg
    leaves = named_leaves(model)
    if specs is None:
        if not shards_over_model(mesh, cfg):
            raise ValueError(f"{cfg.name} does not shard over the 'model' "
                             f"axis of a mesh of {mesh.shape}")
        check_tp(cfg, mesh.shape["model"])
        layout = {n: None if model_dim(cfg, n) is None else leaf_spec(
            cfg, n, len(local_tensors(x)[0].shape)) for n, x in leaves}
    else:
        if shards_over_model(mesh, cfg):
            check_tp(cfg, mesh.shape["model"])
        layout = {n: layout_spec(specs[n], mesh, cfg) for n, _ in leaves}
    root = canon_device(mesh.devices[0])
    # (a serving step may place the model inside inference mode: the
    # blocks stay ordinary tensors, which a train step may update)
    with torch.inference_mode(False), torch.no_grad():
        _place_leaves(model, mesh, leaves, root, values, only, layout)
    model._leaf_names = [n for n, _ in leaves]
    model._placed_on = mesh
    model._placed_only = only
    model._placed_specs = None if specs is None else dict(specs)
    _restore_order(model)
    return model


def _place_leaves(model, mesh, leaves, root, values, only, layout) -> None:
    for name, leaf in leaves:
        src = leaf if values is None else values[name]
        if isinstance(src, Placed):
            src = src.full()
        src = src if torch.is_tensor(src) else torch.as_tensor(
            np.asarray(src))
        grad = local_tensors(leaf)[0].requires_grad
        dtype = local_tensors(leaf)[0].dtype
        if layout[name] is None:
            if values is None and not isinstance(leaf, Placed) and (
                    canon_device(leaf.device) == root):
                continue
            new = torch.nn.Parameter(src.detach().to(
                root, dtype, copy=True), requires_grad=grad)
        else:
            new = place(src, mesh, layout[name], own=True, only=only,
                        dtype=dtype)
            for t in local_tensors(new):
                t.requires_grad_(grad)
        _set_leaf(model, name, new)
        del src


def placed_specs(model) -> Optional[Dict[str, P]]:
    """The spec tree `model` was laid out by (`place_model(...,
    specs=)`), or None."""
    return getattr(model, "_placed_specs", None)


def gather_model(model):
    """The inverse of `place_model`, in place: each placed leaf a whole
    Parameter again on the model's device (`Placed.full`)."""
    if placed_mesh(model) is None:
        return model
    root = model.device
    with torch.inference_mode(False), torch.no_grad():
        for name, leaf in named_leaves(model):
            if isinstance(leaf, Placed):
                grad = local_tensors(leaf)[0].requires_grad
                _set_leaf(model, name, torch.nn.Parameter(
                    leaf.full(root), requires_grad=grad))
    _restore_order(model)
    for attr in ("_leaf_names", "_placed_on", "_placed_only",
                 "_placed_specs"):
        model.__dict__.pop(attr, None)
    return model


def _restore_order(model) -> None:
    """Each module's Parameters registered in `_leaf_names`' order, the
    order of a model never placed (`_set_leaf` registers a leaf anew at
    the end), so `named_parameters`, the state dict and the global
    norm's sums keep it."""
    owners: Dict[int, Tuple[torch.nn.Module, List[str]]] = {}
    for name in model._leaf_names:
        mod, leaf = _owner(model, name)
        owners.setdefault(id(mod), (mod, []))[1].append(leaf)
    for mod, names in owners.values():
        params = mod._parameters
        order = [k for k in names if k in params] + [
            k for k in params if k not in names]
        items = [(k, params[k]) for k in order]
        params.clear()
        params.update(items)


def lay_out_model(model, specs: Optional[Dict[str, P]] = None):
    """`model` laid out, in place, for the active mesh (`use_mesh`), and
    returned. With `specs` (a spec tree, `param_specs`), by that tree
    (`place_model(..., specs=)`) unless it is laid out so already. A
    model laid out by a spec tree keeps that layout on its mesh, and on
    another mesh is laid out anew by the same tree (the axes that mesh
    lacks dropped). Otherwise placed on the mesh where its config shards
    over its 'model' axis (`place_model`; a model placed on another mesh
    is laid out anew), whole leaves otherwise (`gather_model`). Without
    a mesh the leaves are whole, but a model placed for some entries
    alone (`entry_model`, the dry-run's traced entry) cannot be gathered
    and stays as it is. The train and serving steps call it first."""
    mesh = current_mesh()
    placed = placed_mesh(model)
    if mesh is not None:
        held = placed_specs(model)
        if specs is not None or held is not None:
            want = held if specs is None else dict(specs)
            if placed == mesh and held == want:
                return model
            return place_model(model, mesh, specs=want)
    target = mesh if shards_over_model(mesh, model.cfg) else None
    if placed == target or (target is None and getattr(
            model, "_placed_only", None) is not None):
        return model
    if target is None:
        return gather_model(model)
    return place_model(model, target)


def entry_model(model, tp: int, mesh: Optional[Mesh] = None):
    """The model the dry-run traces, laid out for mesh entry 0 alone,
    whose state holds what entry 0 of a real mesh holds: `place_model`
    for entry 0 (`traced_entry`) of a 'model' extent `tp` on `model`'s
    device; with `mesh` (a production mesh, of meta devices like
    `model`), the reference's layout on it instead (`param_specs`:
    FSDP on 'data' and the 'model' blocks where the config shards)."""
    if mesh is not None:
        with use_mesh(mesh):
            specs = param_specs(model)
        return place_model(model, mesh, only=(0,), specs=specs)
    mesh = Mesh((model.device,) * tp, ("model",), (tp,))
    return place_model(model, mesh, only=(0,))


def _allreduce(parts: List[torch.Tensor], tp: int, op: str,
               kind: str) -> torch.Tensor:
    acc = parts[0].to(torch.float32, copy=True)
    for p in parts[1:]:
        p = p.to(acc.device, torch.float32)
        acc = acc + p if op == "sum" else torch.maximum(acc, p)
    return acc.to(parts[0].dtype)


def _allreduce_fake(parts, tp, op, kind):
    return parts[0].new_empty(parts[0].shape)


def _allgather(parts: List[torch.Tensor], tp: int, size: int,
               kind: str) -> torch.Tensor:
    dev = parts[0].device
    out = torch.cat([p.to(dev) for p in parts], dim=-1)
    short = size - out.shape[-1]
    return out if short == 0 else torch.nn.functional.pad(out, (0, short))


def _allgather_fake(parts, tp, size, kind):
    return parts[0].new_empty(parts[0].shape[:-1] + (size,))


MODEL_ALLREDUCE = oplib.define(
    "model_allreduce(Tensor[] parts, int tp, str op, str kind) -> Tensor",
    _allreduce, _allreduce_fake, _allreduce)
MODEL_ALLGATHER = oplib.define(
    "model_allgather(Tensor[] parts, int tp, int size, str kind) -> Tensor",
    _allgather, _allgather_fake, _allgather)


class _ModelSum(torch.autograd.Function):
    """The entries' partials summed (`model_allreduce`), cast once to
    `dtype`; the backward hands each entry the output's gradient."""

    @staticmethod
    def forward(ctx, tp, kind, dtype, *parts):
        ctx.dests = [(p.device, p.dtype) for p in parts]
        out = MODEL_ALLREDUCE(list(parts), tp, "sum", kind)
        return out if dtype is None else out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return (None, None, None) + tuple(g.to(dev, dt)
                                          for dev, dt in ctx.dests)


class _PartialMM(torch.autograd.Function):
    """a @ b of one precision below float32 with a float32 result: the
    products accumulate in float32 and stay unrounded. The backward
    rounds the output's gradient to a's dtype, which is exact where it
    comes from a `model_sum` of that dtype, and runs in it, as the
    unsharded product's backward does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cpu":
            return a.float() @ b.float()
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ b.t() if ctx.needs_input_grad[0] else None,
                a.t() @ g if ctx.needs_input_grad[1] else None)


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """An entry's partial of a row-parallel product (attention's output
    projection, the MLP's wo) with activations below float32: x (..., K)
    times w (K, d) cast to x's dtype, as a float32 result, so that
    `model_sum` rounds the sum once, as the unsharded product rounds its
    result."""
    w = w.to(x.dtype)
    return _PartialMM.apply(x.reshape(-1, x.shape[-1]), w).reshape(
        x.shape[:-1] + w.shape[-1:])


class _ColumnMM(torch.autograd.Function):
    """a @ w, where a is a float32 carrier of values of w's dtype (below
    float32): the product in w's dtype, as the unsharded one; the
    backward gives a's gradient in float32, unrounded (the sum over this
    entry's columns alone), and w's in its dtype, as the unsharded
    product's backward does."""

    @staticmethod
    def forward(ctx, a, w):
        a = a.to(w.dtype)
        ctx.save_for_backward(a, w)
        return a @ w

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = (g.float() @ w.float().t() if g.device.type == "cpu"
                  else torch.mm(g, w.t(), out_dtype=torch.float32))
        if ctx.needs_input_grad[1]:
            gw = a.t() @ g
        return ga, gw


def column_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """An entry's column-parallel product (its block of q, k, v heads, of
    the MLP's d_ff columns, of the vocab's logits) of x (..., K), a
    float32 carrier from `model_copy(..., wide=True)`, and w (K, ...) in
    the activation dtype: x · w in that dtype, whose backward hands x a
    float32 gradient, so that `model_copy`'s all-reduce sums the
    entries' partials unrounded and rounds the input's gradient once,
    as the unsharded product's backward rounds it."""
    k = w.shape[0]
    y = _ColumnMM.apply(x.reshape(-1, k), w.reshape(k, -1))
    return y.reshape(x.shape[:-1] + w.shape[1:])


class _ModelCopy(torch.autograd.Function):
    """A replicated input handed to each entry (on its device), or a
    float32 carrier of it (`wide`); the backward sums the entries'
    gradients of it (`model_allreduce`, in float32) and casts the sum
    once to its dtype: the gradient's all-reduce at the input of a
    sharded region."""

    @staticmethod
    def forward(ctx, tp, kind, devices, wide, x):
        ctx.tp, ctx.kind, ctx.src = tp, kind, (x.device, x.dtype)
        if wide:
            x = x.to(torch.float32)
        return tuple(x.to(d).view_as(x) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        dev, dt = ctx.src
        gs = [g for g in grads if g is not None]
        if not gs:
            return None, None, None, None, None
        g = MODEL_ALLREDUCE([x.to(dev) for x in gs], ctx.tp, "sum",
                            ctx.kind + ":bwd")
        return None, None, None, None, g.to(dt)


def model_copy(x: torch.Tensor, entries: Entries, kind: str,
               wide: bool = False) -> List[torch.Tensor]:
    """`x` (replicated) for each entry, on its device; differentiable: the
    entries' gradients of it are summed in mesh order in float32 and
    cast to its dtype. `kind` names the gradient's all-reduce. With
    `wide`, where x is below float32 and autograd records it, each entry
    gets a float32 carrier of x instead, for its column-parallel
    products (`column_product`), whose float32 gradients are then summed
    and rounded once."""
    wide = (wide and x.dtype != torch.float32 and x.requires_grad
            and torch.is_grad_enabled())
    return list(_ModelCopy.apply(entries.tp, kind, entries.devices, wide, x))


def model_sum(parts: Sequence[torch.Tensor], entries: Entries, kind: str,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The entries' partials (one each, in `entries`' order) summed in
    mesh order in float32, cast once to `dtype` (default: theirs), on the
    first one's device; differentiable. `kind` names the reduction in the
    dry-run's records, which count the partials' bytes."""
    return _ModelSum.apply(entries.tp, kind, dtype, *parts)


def model_max(parts: Sequence[torch.Tensor], entries: Entries,
              kind: str) -> torch.Tensor:
    """The entries' partials' elementwise max, on the first one's device
    (no gradient)."""
    return MODEL_ALLREDUCE([p.detach() for p in parts], entries.tp, "max",
                           kind)


def model_gather(parts: Sequence[torch.Tensor], entries: Entries, size: int,
                 kind: str) -> torch.Tensor:
    """The entries' blocks of a last dimension of `size`, concatenated in
    mesh order on the first one's device (serving's logits; no
    gradient). A traced entry's gather holds its block, then zeros."""
    return MODEL_ALLGATHER([p.detach() for p in parts], entries.tp, size,
                           kind)


MODEL_COLLECTIVES = (MODEL_ALLREDUCE, MODEL_ALLGATHER)


# ------------------------- FSDP over the batch axes -------------------------
BATCH_AXES = ("pod", "data")


def drop_batch_axes(p: Sequence) -> P:
    """`p` without the batch axes: the 'model' layout of an FSDP leaf."""
    def fix(entry):
        kept = tuple(a for a in _entry_axes(entry) if a not in BATCH_AXES)
        return kept if kept else None

    return P(*[fix(e) for e in p])


def is_fsdp(w) -> bool:
    """Whether `w` is a Placed value whose spec names a batch axis."""
    return isinstance(w, Placed) and any(
        a in BATCH_AXES for e in w.spec for a in _entry_axes(e))


def gather_sources(w: Placed, j: int) -> Tuple[int, List[int]]:
    """(the dimension of an FSDP leaf `w` that its spec gives to batch
    axes, the mesh entries whose blocks make up mesh entry j's gathered
    block, in block order: those at j's coordinates on every other axis).
    Raises where batch axes shard more than one dimension or share one
    with 'model'. Kept on `w` per entry (a step asks for each many
    times)."""
    cache = w.__dict__.setdefault("_sources", {})
    if j not in cache:
        cache[j] = _gather_sources(w, j)
    return cache[j]


def _gather_sources(w: Placed, j: int) -> Tuple[int, List[int]]:
    dims = [d for d, e in enumerate(w.spec)
            if set(_entry_axes(e)) & set(BATCH_AXES)]
    if len(dims) != 1 or not set(_entry_axes(w.spec[dims[0]])) <= set(
            BATCH_AXES):
        raise ValueError(f"{w!r}: FSDP gathers one dimension of batch axes "
                         f"alone")
    d, mesh = dims[0], w.mesh
    axes = _entry_axes(w.spec[d])
    sizes = [mesh.shape[a] for a in axes]
    at = entry_coords(mesh, j)
    out = []
    for k in range(int(np.prod(sizes, dtype=np.int64))):
        at.update(zip(axes, (int(c) for c in np.unravel_index(k, sizes))))
        out.append(int(np.ravel_multi_index(
            [at[a] for a in mesh.axis_names], mesh.axis_sizes)))
    return d, out


def data_gather(w: Placed, j: int,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mesh entry j's block of the FSDP leaf `w` with its batch-axis
    blocks gathered (`gather_sources`), in `dtype` (default: w's), on
    j's device; differentiable (`data_allgather`). Blocks that the value
    does not hold (a model placed for some entries, `entry_model`) are
    left out: the gather holds the present ones, then zeros."""
    d, src = gather_sources(w, j)
    parts = [w.shards[i] for i in src if w.shards[i] is not None]
    dev = canon_device(w.mesh.devices[j])
    return _DataGather.apply(d, w.shape[d], len(src),
                             w.dtype if dtype is None else dtype, dev,
                             "gather", *parts)


def _datagather(parts: List[torch.Tensor], dim: int, size: int, n: int,
                dtype: torch.dtype, device: torch.device,
                kind: str) -> torch.Tensor:
    shape = list(parts[0].shape)
    shape[dim] = size
    held = sum(p.shape[dim] for p in parts)
    out = (torch.empty if held == size else torch.zeros)(
        shape, dtype=dtype, device=device)
    if held == size and all(p.device == out.device for p in parts):
        return torch.cat(parts, dim, out=out)    # one launch, cast included
    off = 0
    for p in parts:
        out.narrow(dim, off, p.shape[dim]).copy_(p)
        off += p.shape[dim]
    return out


def _datagather_fake(parts, dim, size, n, dtype, device, kind):
    shape = list(parts[0].shape)
    shape[dim] = size
    return parts[0].new_empty(shape, dtype=dtype, device=device)


def _datascatter(grad: torch.Tensor, dim: int, sizes: List[int], n: int,
                 dtype: torch.dtype, kind: str) -> List[torch.Tensor]:
    out, off = [], 0
    for k in sizes:
        out.append(grad.narrow(dim, off, k).to(
            dtype, memory_format=torch.contiguous_format, copy=True))
        off += k
    return out


def _datascatter_fake(grad, dim, sizes, n, dtype, kind):
    out = []
    for k in sizes:
        shape = list(grad.shape)
        shape[dim] = k
        out.append(grad.new_empty(shape, dtype=dtype))
    return out


DATA_ALLGATHER = oplib.define(
    "data_allgather(Tensor[] parts, int dim, int size, int n, "
    "ScalarType dtype, Device device, str kind) -> Tensor",
    _datagather, _datagather_fake, _datagather)
DATA_REDUCESCATTER = oplib.define(
    "data_reducescatter(Tensor grad, int dim, int[] sizes, int n, "
    "ScalarType dtype, str kind) -> Tensor[]",
    _datascatter, _datascatter_fake, _datascatter)
DATA_COLLECTIVES = (DATA_ALLGATHER, DATA_REDUCESCATTER)


class _DataGather(torch.autograd.Function):
    """The blocks of an FSDP leaf cast to a dtype and concatenated along
    their dimension on one device (`data_allgather`); the backward hands
    each block its slice of the gradient, in its dtype, on its device
    (`data_reducescatter`: the data shards' slices of a block are then
    summed by the train step, on the block's keeper)."""

    @staticmethod
    def forward(ctx, dim, size, n, dtype, device, kind, *parts):
        ctx.dim, ctx.n, ctx.kind = dim, n, kind
        ctx.dests = [(p.device, p.dtype, p.shape[dim]) for p in parts]
        return DATA_ALLGATHER(list(parts), dim, size, n, dtype, device, kind)

    @staticmethod
    def backward(ctx, g):
        pieces = DATA_REDUCESCATTER(g, ctx.dim, [k for *_, k in ctx.dests],
                                    ctx.n, ctx.dests[0][1],
                                    ctx.kind + ":bwd")
        return (None,) * 6 + tuple(p.to(dev) for p, (dev, _, _) in
                                   zip(pieces, ctx.dests))
