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
    `jax.device_put(x, NamedSharding(mesh, p))`; `.full()` gathers it.
    A local tensor that is already on its entry's device is a view of
    the input, so shards of one device share its memory.
  * `param_specs(model)`: each parameter name of the port's `LM` to the
    `P` of its logical axes, the specs `LM.init` returns in the
    reference, with the `scan` layout's leading `stack` axis dropped
    (the port's leaves are per layer).

`shard` and `fsdp_use` return their input: placement constraints are
XLA's, and the port's eager model has nothing to constrain.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.distributed import Mesh

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


def fsdp_use(w: torch.Tensor, *logical: Axes) -> torch.Tensor:
    """The reference's gathered-weight constraint: w unchanged."""
    return w


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
    `shards[j]` is mesh entry j's block, on `mesh.devices[j]`."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh, p: P,
                 shape: Tuple[int, ...]):
        self.shards = tuple(shards)
        self.mesh = mesh
        self.spec = p
        self.shape = tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor (a new one) on `device`, mesh entry 0's by
        default, from the first entry that holds each block."""
        dev = self.mesh.devices[0] if device is None else torch.device(
            device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen = set()
        for j, local in enumerate(self.shards):
            sl = block_slices(self.shape, self.spec, self.mesh.shape,
                              entry_coords(self.mesh, j))
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl] = local.to(dev)
        return out

    def __repr__(self):
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.axis_names}"
                f"{self.mesh.axis_sizes})")


def place(x, mesh: Mesh, p: Sequence = ()) -> Placed:
    """`x` (a tensor, a numpy array or a Placed value) laid out over
    `mesh` by `p`: each entry's block on its device."""
    if isinstance(x, Placed):
        x = x.full()
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    p = _check_spec(p, t.dim(), mesh)
    shards = [t[block_slices(t.shape, p, mesh.shape,
                             entry_coords(mesh, j))].to(dev)
              for j, dev in enumerate(mesh.devices)]
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
            for name, _ in model.named_parameters()}
