"""Interval-arithmetic range propagation over aten graphs.

The port's twin of `repro.analysis.ranges`. The pipeline packs integers:
the dist·(n+1) + id relaxation key of `bfs.bfs_doubling`, the
(tail << 16) | head arc key of `bfs.root_tree_euler`, and every pack
carries an implicit "fits its dtype" proof. This module checks those
proofs:

  * `Interval`: integer/float interval arithmetic with an optional
    out-of-band *sentinel* value (the INT32_MAX "unreachable" marker
    BFS depths carry). `[0, n] ∪ {INF}` is `Interval(0, n,
    sentinel=INF)`, and arithmetic tells "the finite range overflows"
    from "the sentinel escaped into arithmetic". Its semantics are the
    reference's, operation for operation.
  * `propagate` / `check_ranges`: seed a program's inputs with
    intervals, trace it into an aten graph (`make_fx` on CPU tensors)
    and walk the graph, flagging each op whose result provably exceeds
    its dtype (`int-overflow`), casts a sentinel into float arithmetic
    (`sentinel-escape`, the unclamped-INF-depth bug), or narrows past
    its input range (`cast-overflow`). An op the model does not cover
    yields TOP (unknown), which never flags: every finding is real. An
    op that writes into one of its inputs makes that input TOP too.
  * the symbolic bound models: `packed_key_interval(n)`,
    `derive_packed_key_max_n()`, `euler_pack_interval(n)` and
    `derive_euler_pack_max_n()` derive the switch points that
    `core/bfs.py` hard-codes, independently of it (the audit asserts
    both agree).

The select-refinement rule is what lets clean code pass: the guard
``torch.where(x == SENTINEL, repl, x)`` (`bfs.finite_depth`) strips the
sentinel from the branch taken where x != SENTINEL, so downstream float
casts are provably sentinel-free, while the same cast *without* the
guard is flagged. Only the seeded values and what derives from them are
checked; a loop's carry is whatever the traced iterations computed, so
in-loop invariants are checked on witness programs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

INT32_MAX = 2 ** 31 - 1
INT32_MIN = -(2 ** 31)
# The largest node count the port takes: ids and depths are int32 values
# below the INF = INT32_MAX sentinel (and the CUDA kernels' counts are
# int32), so n - 1 < INF.
PORT_MAX_N = INT32_MAX - 1

_INT_BOUNDS = {
    "int8": (-(2 ** 7), 2 ** 7 - 1),
    "int16": (-(2 ** 15), 2 ** 15 - 1),
    "int32": (INT32_MIN, INT32_MAX),
    "int64": (-(2 ** 63), 2 ** 63 - 1),
    "uint8": (0, 2 ** 8 - 1),
    "uint16": (0, 2 ** 16 - 1),
    "uint32": (0, 2 ** 32 - 1),
    "uint64": (0, 2 ** 64 - 1),
}


def dtype_name(dtype) -> str:
    """'int32' for torch.int32, 'int32', or anything whose str ends so
    (a numpy dtype)."""
    return str(dtype).replace("torch.", "")


def dtype_bounds(dtype) -> Optional[Tuple[int, int]]:
    return _INT_BOUNDS.get(dtype_name(dtype))


def is_float(dtype) -> bool:
    return dtype_name(dtype).startswith(("float", "bfloat", "complex"))


@dataclasses.dataclass(frozen=True)
class Interval:
    """[lo, hi] plus an optional out-of-band sentinel the value may
    also take (e.g. BFS depth ∈ [0, n-1] ∪ {INT32_MAX}). `unknown`
    marks TOP: nothing is known, and nothing derived from it flags."""

    lo: float = 0
    hi: float = 0
    sentinel: Optional[int] = None
    unknown: bool = False

    # -------------------------------------------------------- builders
    @staticmethod
    def top() -> "Interval":
        return Interval(unknown=True)

    @staticmethod
    def const(c) -> "Interval":
        c = float(c) if isinstance(c, float) else c
        return Interval(lo=c, hi=c)

    @staticmethod
    def of(lo, hi, sentinel: Optional[int] = None) -> "Interval":
        return Interval(lo=lo, hi=hi, sentinel=sentinel)

    # ---------------------------------------------------------- views
    def hull_with_sentinel(self) -> "Interval":
        """Fold the sentinel into the range (what arithmetic on the raw
        values actually sees)."""
        if self.unknown or self.sentinel is None:
            return self
        return Interval(min(self.lo, self.sentinel),
                        max(self.hi, self.sentinel))

    def fits(self, dtype) -> bool:
        b = dtype_bounds(dtype)
        if b is None or self.unknown:
            return True
        eff = self.hull_with_sentinel()
        return b[0] <= eff.lo and eff.hi <= b[1]

    def union(self, other: "Interval") -> "Interval":
        if self.unknown or other.unknown:
            return Interval.top()
        s = self.sentinel if self.sentinel is not None else other.sentinel
        if (self.sentinel is not None and other.sentinel is not None
                and self.sentinel != other.sentinel):
            # two distinct sentinels: fold both into the range
            return self.hull_with_sentinel().union(
                other.hull_with_sentinel())
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi),
                        sentinel=s)

    # ------------------------------------------------------ arithmetic
    def _binop(self, other: "Interval",
               f: Callable[[float, float], float]) -> "Interval":
        if self.unknown or other.unknown:
            return Interval.top()
        a, b = self.hull_with_sentinel(), other.hull_with_sentinel()
        vals = [f(a.lo, b.lo), f(a.lo, b.hi), f(a.hi, b.lo), f(a.hi, b.hi)]
        return Interval(min(vals), max(vals))

    def __add__(self, other):
        return self._binop(_coerce(other), lambda x, y: x + y)

    def __sub__(self, other):
        return self._binop(_coerce(other), lambda x, y: x - y)

    def __mul__(self, other):
        return self._binop(_coerce(other), lambda x, y: x * y)

    def min_(self, other):
        return self._binop(_coerce(other), min)

    def max_(self, other):
        return self._binop(_coerce(other), max)

    def neg(self):
        if self.unknown:
            return self
        h = self.hull_with_sentinel()
        return Interval(-h.hi, -h.lo)

    def taints_float(self) -> bool:
        """True when casting this value to float would launder the
        sentinel into arithmetic (the unclamped-INF-depth poisoning)."""
        return (not self.unknown) and self.sentinel is not None


def _coerce(x) -> Interval:
    if isinstance(x, Interval):
        return x
    return Interval.const(x)


# ---------------------------------------------------------------------
# symbolic bound models (the checker side of core/bfs.py's constants)
# ---------------------------------------------------------------------

def packed_key_interval(n: int) -> Interval:
    """Model of `bfs.bfs_doubling`'s fused relaxation key at node count
    n: dist·(n+1) + id with dist clamped to [0, n] and id ∈ [0, n].
    Mirrors `bfs.packed_key_bound(n)`; the audit asserts both agree."""
    dist = Interval.of(0, n)
    node = Interval.of(0, n)
    return dist * Interval.const(n + 1) + node


def derive_packed_key_max_n() -> int:
    """Largest n for which the packed relaxation key provably fits
    int32, derived from the interval model (not from the runtime's own
    constant: two independent derivations)."""
    # key_max = (n+1)^2 - 1 is monotone in n: binary search the switch.
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if packed_key_interval(mid).fits("int32"):
            lo = mid
        else:
            hi = mid - 1
    return lo


def euler_pack_interval(n: int) -> Interval:
    """Model of `bfs.root_tree_euler`'s u32 (tail << 16 | head) arc
    key: exact for tail, head ∈ [0, n]."""
    return Interval.of(0, n) * Interval.const(1 << 16) + Interval.of(0, n)


def derive_euler_pack_max_n() -> int:
    """Largest n whose (tail, head) pair packs into u32 with 16-bit
    fields: fields must not collide, so n itself is bounded by the
    field width, not just the u32 range."""
    n = (1 << 16) - 1
    assert euler_pack_interval(n).fits("uint32")
    return n


# ---------------------------------------------------------------------
# aten-graph propagation
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RangeFinding:
    kind: str          # "int-overflow" | "sentinel-escape" | "cast-overflow"
    op: str
    node_index: int    # index into the graph's nodes
    detail: str

    def __str__(self):
        return (f"[{self.kind}] node {self.node_index} ({self.op}): "
                f"{self.detail}")


def _const_interval(val) -> Interval:
    if isinstance(val, bool):
        return Interval.of(int(val), int(val))
    if isinstance(val, (int, float)):
        if isinstance(val, float) and not math.isfinite(val):
            return Interval.top()
        return Interval.const(val)
    if not isinstance(val, torch.Tensor) or val.numel() == 0:
        return Interval.top()
    if val.dtype == torch.bool:
        return Interval.of(0, 1)
    if val.is_floating_point():
        finite = val[torch.isfinite(val)]
        if finite.numel() == 0:
            return Interval.top()
        return Interval.of(float(finite.min()), float(finite.max()))
    if val.is_complex():
        return Interval.top()
    return Interval.of(int(val.min()), int(val.max()))


def _op_name(target) -> str:
    """'add' for aten.add.Tensor (the overload packet's name)."""
    name = getattr(target, "__name__", str(target))
    return name.split(".")[0]


def _out_dtype(node):
    val = node.meta.get("val")
    return getattr(val, "dtype", None)


def _numel(node) -> int:
    val = node.meta.get("val")
    return int(val.numel()) if isinstance(val, torch.Tensor) else 1


_PASSTHROUGH = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "clone", "slice",
    "select", "index", "permute", "t", "transpose", "squeeze",
    "unsqueeze", "flatten", "alias", "detach", "lift_fresh_copy",
    "gather", "index_select", "roll", "contiguous", "flip", "repeat",
    "amax", "amin", "_unsafe_index", "take_along_dim", "as_strided",
    "expand_copy", "view_copy", "unfold",
})
_BOOL_OUT = frozenset({
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor", "isfinite", "isinf", "isnan", "any",
    "all",
})
_CONST_LIKE = {"zeros_like": 0, "ones_like": 1, "zeros": 0, "ones": 1}


class _Env:
    """node -> Interval over one graph, plus predicate provenance
    (`eq(x, K)` facts) for the select-refinement rule."""

    def __init__(self, gm):
        self.gm = gm
        self.vals: Dict[Any, Interval] = {}
        self.eq_facts: Dict[Any, Tuple[Any, int]] = {}

    def read(self, a) -> Interval:
        if isinstance(a, torch.fx.Node):
            return self.vals.get(a, Interval.top())
        if isinstance(a, (list, tuple)):
            ivs = [self.read(x) for x in a]
            out = ivs[0] if ivs else Interval.top()
            for iv in ivs[1:]:
                out = out.union(iv)
            return out
        if a is None:
            return Interval.top()
        return _const_interval(a)


def _refine_where(env: _Env, node) -> Optional[Interval]:
    """where(pred, a, b) with pred == eq(x, K): b, taken where x != K,
    is x with the sentinel K stripped; a is taken as-is. Returns the
    refined union, or None when the pattern does not apply."""
    pred, a, b = node.args[:3]
    fact = env.eq_facts.get(pred)
    if fact is None:
        return None
    x_node, k = fact
    iv_b = env.read(b)
    if b is x_node and not iv_b.unknown:
        if iv_b.sentinel == k:
            iv_b = Interval(iv_b.lo, iv_b.hi)          # sentinel stripped
        elif iv_b.hi == k:
            iv_b = Interval(iv_b.lo, k - 1, iv_b.sentinel)
    return env.read(a).union(iv_b)


def _shift(iv: Interval, k) -> Interval:
    if iv.unknown or not isinstance(k, int) or k < 0:
        return Interval.top()
    return iv * Interval.const(1 << k)


def _overflow(findings, name, idx, iv, dt, what="result range") -> bool:
    if iv.unknown or dtype_bounds(dt) is None or iv.fits(dt):
        return False
    findings.append(RangeFinding(
        "int-overflow", name, idx,
        f"{what} [{iv.lo}, {iv.hi}] exceeds {dtype_name(dt)}"))
    return True


def _step(env: _Env, node, idx: int, findings: List[RangeFinding]
          ) -> Interval:
    name = _op_name(node.target)
    args = node.args
    dt = _out_dtype(node)

    if name in ("add", "sub", "mul", "rsub"):
        a, b = env.read(args[0]), env.read(args[1])
        if node.kwargs.get("alpha", 1) != 1:
            return Interval.top()
        out = {"add": lambda: a + b, "sub": lambda: a - b,
               "mul": lambda: a * b, "rsub": lambda: b - a}[name]()
        if dt is not None and not is_float(dt) \
                and _overflow(findings, name, idx, out, dt):
            return Interval.top()
        return out
    if name in ("__lshift__", "lshift", "bitwise_left_shift"):
        k = args[1] if not isinstance(args[1], torch.fx.Node) else None
        out = _shift(env.read(args[0]), k)
        if _overflow(findings, name, idx, out, dt):
            return Interval.top()
        return out
    if name == "bitwise_or":
        a, b = env.read(args[0]).hull_with_sentinel(), \
            env.read(args[1]).hull_with_sentinel()
        if a.unknown or b.unknown or a.lo < 0 or b.lo < 0:
            return Interval.top()
        out = Interval(max(a.lo, b.lo), a.hi + b.hi)   # a|b <= a + b
        if _overflow(findings, name, idx, out, dt):
            return Interval.top()
        return out
    if name == "bitwise_and":
        a, b = env.read(args[0]).hull_with_sentinel(), \
            env.read(args[1]).hull_with_sentinel()
        if a.unknown or b.unknown or a.lo < 0 or b.lo < 0:
            return Interval.top()
        return Interval(0, min(a.hi, b.hi))
    if name == "neg":
        return env.read(args[0]).neg()
    if name == "maximum":
        return env.read(args[0]).max_(env.read(args[1]))
    if name == "minimum":
        return env.read(args[0]).min_(env.read(args[1]))
    if name in ("clamp", "clamp_min", "clamp_max"):
        x = env.read(args[0])
        lo = args[1] if len(args) > 1 else node.kwargs.get("min")
        hi = args[2] if len(args) > 2 else node.kwargs.get("max")
        if name == "clamp_max":
            lo, hi = None, lo
        if x.unknown:
            return x
        out = x
        if lo is not None:
            out = out.max_(env.read(lo))
        if hi is not None:
            out = out.min_(env.read(hi))
        return out
    if name == "where":
        refined = _refine_where(env, node)
        if refined is not None:
            return refined
        return env.read(args[1]).union(env.read(args[2]))
    if name in ("_to_copy", "to", "_convert_element_type"):
        src = env.read(args[0])
        to = node.kwargs.get("dtype", dt)
        if to is None:
            return src
        if is_float(to) and src.taints_float():
            findings.append(RangeFinding(
                "sentinel-escape", name, idx,
                f"integer sentinel {src.sentinel} cast into "
                f"{dtype_name(to)} arithmetic"))
            return Interval.top()
        if not src.fits(to):
            findings.append(RangeFinding(
                "cast-overflow", name, idx,
                f"range [{src.lo}, {src.hi}]"
                + (f" ∪ {{{src.sentinel}}}" if src.sentinel is not None
                   else "")
                + f" does not fit {dtype_name(to)}"))
            return Interval.top()
        return src
    if name == "arange":
        nums = [a for a in args if isinstance(a, (int, float))]
        if len(nums) == 1:
            return Interval.of(0, max(nums[0] - 1, 0))
        if len(nums) >= 2 and (len(nums) == 2 or nums[2] == 1):
            return Interval.of(nums[0], max(nums[1] - 1, nums[0]))
        return Interval.top()
    if name in _CONST_LIKE:
        return Interval.const(_CONST_LIKE[name])
    if name in ("full_like", "full", "scalar_tensor", "fill"):
        val = args[1] if name in ("full_like", "full", "fill") else args[0]
        return env.read(val)
    if name in ("sum", "cumsum"):
        src = env.read(args[0])
        if src.unknown:
            return src
        cnt = max(_numel(args[0]), 1)
        h = src.hull_with_sentinel()
        out = Interval(min(h.lo * cnt, h.lo), max(h.hi * cnt, h.hi))
        if dt is not None and _overflow(findings, name, idx, out, dt,
                                        "sum bound"):
            return Interval.top()
        return out
    if name in ("max", "min") and len(args) == 1:
        return env.read(args[0])
    if name in ("argmax", "argmin"):
        return Interval.of(0, max(_numel(args[0]) - 1, 0))
    if name in ("cat", "stack"):
        return env.read(list(args[0]))
    if name in _PASSTHROUGH:
        return env.read(args[0])
    if name in _BOOL_OUT:
        if name == "eq":
            for x_node, k_atom in ((args[0], args[1]), (args[1], args[0])):
                kiv = env.read(k_atom)
                if isinstance(x_node, torch.fx.Node) and not kiv.unknown \
                        and kiv.lo == kiv.hi:
                    env.eq_facts[node] = (x_node, kiv.lo)
                    break
        return Interval.of(0, 1)
    return Interval.top()


def _mutated_args(node) -> List[Any]:
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return []
    out = []
    for arg, a in zip(schema.arguments, node.args):
        info = arg.alias_info
        if info is not None and info.is_write and isinstance(
                a, torch.fx.Node):
            out.append(a)
    return out


def propagate_graph(gm: torch.fx.GraphModule, seeds: Sequence[Interval]
                    ) -> Tuple[List[RangeFinding], List[Interval]]:
    """Walk `gm` (an aten graph) with input intervals `seeds` (one per
    placeholder; Interval.top() for "unknown"). Returns (every provable
    range finding, the outputs' intervals)."""
    env = _Env(gm)
    findings: List[RangeFinding] = []
    seeds = list(seeds)
    outs: List[Interval] = []
    for idx, node in enumerate(gm.graph.nodes):
        if node.op == "placeholder":
            env.vals[node] = seeds.pop(0) if seeds else Interval.top()
        elif node.op == "get_attr":
            env.vals[node] = _const_interval(getattr(gm, node.target))
        elif node.op == "call_function":
            iv = _step(env, node, idx, findings)
            val = node.meta.get("val")
            if not isinstance(val, torch.Tensor):
                iv = Interval.top()       # tuple outputs: not modelled
            env.vals[node] = iv
            for a in _mutated_args(node):
                env.vals[a] = Interval.top()
        elif node.op == "output":
            res = node.args[0]
            res = res if isinstance(res, (list, tuple)) else [res]
            outs = [env.read(r) for r in res]
    return findings, outs


def propagate(gm: torch.fx.GraphModule, seeds: Sequence[Interval]
              ) -> List[RangeFinding]:
    """`propagate_graph`'s findings alone (the reference's surface)."""
    return propagate_graph(gm, seeds)[0]


def trace(fn: Callable, *args, static_kwargs: Optional[dict] = None
          ) -> torch.fx.GraphModule:
    """`fn(*args, **static_kwargs)` as an aten graph: `make_fx` on the
    given CPU tensors (the function runs once, on them)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    static_kwargs = static_kwargs or {}
    return make_fx(lambda *a: fn(*a, **static_kwargs))(*args)


def check_ranges(fn: Callable, seeds: Sequence[Interval], *args,
                 static_kwargs: Optional[dict] = None,
                 out_dtypes: Sequence = ()) -> List[RangeFinding]:
    """Trace `fn` over `args` (CPU tensors) and propagate `seeds` (one
    Interval per positional arg, spread over its tensors). `out_dtypes`,
    one per output (None to skip), names the dtype an output is read as
    downstream (the u32 radix key held in int64): an output that does
    not fit it is a `cast-overflow`."""
    gm = trace(fn, *args, static_kwargs=static_kwargs)
    flat: List[Interval] = []
    for s, a in zip(seeds, args):
        leaves = torch.utils._pytree.tree_leaves(a)
        flat.extend([s] * len(leaves))
    findings, outs = propagate_graph(gm, flat)
    for i, (iv, want) in enumerate(zip(outs, out_dtypes)):
        if want is not None and not iv.fits(want):
            findings.append(RangeFinding(
                "cast-overflow", "output", i,
                f"output {i} range [{iv.lo}, {iv.hi}] does not fit "
                f"{dtype_name(want)}, the dtype it is read as"))
    return findings
