"""AST lint pass: source rules for the port's device path.

The graph audit (`graph_audit`) checks what the programs *do* when they
run; this pass checks what the source *says*, and catches what a run on
one input cannot show: a host numpy call in a device function, a factory
that lands on the CPU, a new host sync, a padded edge-list function that
forgot its mask, a handler that swallows a kernel's failure.

Rules (the IDs of `repro.analysis.lint`, retargeted at torch):

  ANA001  host numpy MIXED into a torch function on a device path. A
          function that uses only numpy is a host helper by
          construction; one that interleaves ``np.*`` with ``torch.*``
          either copies a device tensor to the host or feeds host values
          into a device program. Modules under core/ kernels/ serve/
          sparse/ are device paths; functions whose names end in
          ``_np``/``_numpy``/``_host`` and the explicit host modules
          (``_host.py``, ``resistance.py``) are exempt by convention.
  ANA002  unpinned factory on a device path: ``torch.zeros/ones/empty/
          full/eye/arange/linspace`` without ``dtype=`` (the default
          follows ``torch.set_default_dtype``; ``full`` only when its
          fill is a bare literal), and, as its own finding, without
          ``device=``: such a tensor lands on the CPU, a silent
          fallback off the card.
  ANA003  host sync outside the sanctioned sync points: ``.item()``,
          ``.tolist()``, ``.cpu()``, ``.numpy()``,
          ``torch.cuda.synchronize``, and ``bool(...)`` / ``int(...)`` /
          ``float(...)`` around a torch call or a tensor reduction
          (``.any()``, ``.sum()``, ...). ``.item()``, ``.tolist()`` and
          the casts count only in a function that uses torch (numpy
          arrays have them too). Each legitimate sync is baselined with
          its reason; a NEW one fails. The host exemptions of ANA001
          apply.
  ANA004  padded edge-list function without a validity mask: a public
          function taking ``u``, ``v`` and ``n`` operates on the padded
          edge list and must accept a mask parameter
          (``edge_valid``/``edge_mask``/``tree_mask``/``valid``/
          ``mask``/``is_offtree``/``crossing``) or it will process
          garbage pad lanes.
  ANA005  an ``except`` handler on a device path that does not re-raise:
          the fallback that hides a kernel's failure behind a plain
          path (the reference's ANA005, a host callback inside a device
          program, has no torch counterpart; this is its meaning here:
          a device path that silently leaves the device).

Findings carry (rule, path, line, symbol, message). `baseline.json`
sits next to this module: a list of ``{rule, path, symbol, reason}``
entries (symbol ``"*"`` matches the whole file) suppressing the
justified exceptions, so `python -m repro_torch.analysis` fails only on
regressions.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_PATH_DIRS = ("core", "kernels", "serve", "sparse")
HOST_EXEMPT_FILES = ("_host.py", "resistance.py")
HOST_EXEMPT_SUFFIXES = ("_np", "_numpy", "_host")

DTYPE_FACTORIES = ("zeros", "ones", "empty", "full", "eye", "arange",
                   "linspace")
# methods only a torch tensor has (numpy arrays have none of them)
TORCH_SYNC_METHODS = ("cpu", "numpy")
# methods both have: a sync only in a function that uses torch
SHARED_SYNC_METHODS = ("item", "tolist")
CAST_BUILTINS = ("bool", "int", "float")
# a tensor method whose result, cast to a Python scalar, syncs
REDUCTIONS = frozenset({
    "any", "all", "sum", "max", "min", "argmax", "argmin", "prod", "mean",
    "count_nonzero", "item", "norm", "amax", "amin",
})
MASK_PARAM_NAMES = ("edge_valid", "edge_mask", "tree_mask", "valid",
                    "mask", "is_offtree", "crossing")

RULES: Dict[str, str] = {
    "ANA001": "host numpy inside a device-path torch function",
    "ANA002": "factory without an explicit dtype= / device= pin",
    "ANA003": "host sync outside the sanctioned sync points",
    "ANA004": "padded edge-list function without a validity mask param",
    "ANA005": "exception handler on a device path that does not re-raise",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    symbol: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.symbol}] " \
               f"{self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _attr_chain(node: ast.AST) -> str:
    """'torch.zeros' / 'torch.cuda.synchronize' for an Attribute/Name
    chain ('' where the chain starts at another expression)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("")
    return ".".join(reversed(parts))


@dataclasses.dataclass
class _Frame:
    name: str
    np_uses: List[Tuple[ast.AST, str]] = dataclasses.field(
        default_factory=list)
    uses_torch: bool = False
    # (node, message) of ANA003 candidates that count only if the
    # function turns out to use torch
    torch_only_syncs: List[Tuple[ast.AST, str]] = dataclasses.field(
        default_factory=list)


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, relpath: str, device_path: bool):
        self.path = path
        self.relpath = relpath
        self.device_path = device_path
        self.fname = os.path.basename(path)
        self.findings: List[Finding] = []
        self._frames: List[_Frame] = []
        self.numpy_aliases = set()
        self.torch_aliases = set()

    # -- scope helpers -------------------------------------------------
    @property
    def symbol(self) -> str:
        return self._frames[-1].name if self._frames else "<module>"

    def _emit(self, rule: str, node: ast.AST, message: str,
              symbol: Optional[str] = None):
        self.findings.append(Finding(
            rule=rule, path=self.relpath,
            line=getattr(node, "lineno", 0), symbol=symbol or self.symbol,
            message=message))

    def _host_exempt(self, name: Optional[str] = None) -> bool:
        if self.fname in HOST_EXEMPT_FILES:
            return True
        names = [f.name for f in self._frames] + ([name] if name else [])
        return any(f.endswith(HOST_EXEMPT_SUFFIXES) for f in names)

    # -- imports -------------------------------------------------------
    def visit_Import(self, node: ast.Import):
        for a in node.names:
            root = a.name.split(".")[0]
            name = a.asname or root
            if root == "numpy":
                self.numpy_aliases.add(name)
            elif root == "torch":
                self.torch_aliases.add(name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module == "torch":
            for a in node.names:
                self.torch_aliases.add(a.asname or a.name)
        self.generic_visit(node)

    # -- functions -----------------------------------------------------
    def _visit_func(self, node):
        self._check_mask_param(node)
        frame = _Frame(node.name)
        self._frames.append(frame)
        self.generic_visit(node)
        self._frames.pop()
        exempt = self._host_exempt(node.name)
        if frame.uses_torch and not exempt:
            for use, msg in frame.torch_only_syncs:
                self._emit("ANA003", use, msg, node.name)
        if frame.uses_torch and frame.np_uses and self.device_path \
                and not exempt:
            for use, chain in frame.np_uses:
                self._emit(
                    "ANA001", use,
                    f"host numpy call `{chain}` interleaved with torch on "
                    f"a device path (a host copy, or host values fed "
                    f"into the device program)", node.name)
        elif self._frames and not node.name.endswith(HOST_EXEMPT_SUFFIXES):
            # a nested helper: its uses belong to the enclosing frame's
            # decision
            outer = self._frames[-1]
            if not frame.uses_torch:
                outer.np_uses.extend(frame.np_uses)
                outer.torch_only_syncs.extend(frame.torch_only_syncs)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _check_mask_param(self, node):
        if not self.device_path or node.name.startswith("_") \
                or self.fname in HOST_EXEMPT_FILES \
                or node.name.endswith(HOST_EXEMPT_SUFFIXES):
            return
        if self._frames:      # only module-level public API
            return
        args = node.args
        names = [a.arg for a in args.posonlyargs + args.args
                 + args.kwonlyargs]
        if "u" in names and "v" in names and "n" in names:
            if not any(nm in MASK_PARAM_NAMES for nm in names):
                self._emit(
                    "ANA004", node,
                    "public edge-list function takes (u, v, .., n) but no "
                    "validity-mask parameter "
                    f"({', '.join(MASK_PARAM_NAMES[:3])}, ...): pad lanes "
                    "will be processed as real edges", node.name)

    # -- handlers ------------------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if self.device_path and not any(
                isinstance(n, ast.Raise) for b in node.body
                for n in ast.walk(b)):
            caught = ast.unparse(node.type) if node.type else "everything"
            self._emit(
                "ANA005", node,
                f"handler of {caught} does not re-raise: a device path "
                f"that falls back silently hides a kernel's failure")
        self.generic_visit(node)

    # -- calls / attribute use ----------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        chain = _attr_chain(node)
        root = chain.split(".")[0]
        if self._frames:
            if root in self.numpy_aliases:
                self._frames[-1].np_uses.append((node, chain))
            elif root in self.torch_aliases:
                self._frames[-1].uses_torch = True
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def visit_Name(self, node: ast.Name):
        if self._frames and node.id in self.torch_aliases:
            self._frames[-1].uses_torch = True

    def _torch_value(self, node: ast.AST) -> bool:
        """Does `node` contain a torch call or a tensor reduction on a
        receiver that is not numpy?"""
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            chain = _attr_chain(n.func)
            root = chain.split(".")[0]
            if root in self.torch_aliases:
                return True
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in REDUCTIONS \
                    and root not in self.numpy_aliases:
                return True
        return False

    def visit_Call(self, node: ast.Call):
        chain = _attr_chain(node.func)
        parts = chain.split(".")
        leaf = parts[-1]
        root = parts[0]

        # ANA002: factories on device paths
        if self.device_path and leaf in DTYPE_FACTORIES \
                and root in self.torch_aliases and len(parts) == 2:
            kws = {kw.arg for kw in node.keywords}
            hazard = leaf != "full" or (
                len(node.args) >= 2 and isinstance(node.args[1],
                                                   ast.Constant))
            if "dtype" not in kws and hazard:
                self._emit(
                    "ANA002", node,
                    f"`{chain}(...)` without dtype=: the default follows "
                    f"torch.set_default_dtype, not the program")
            if "device" not in kws:
                self._emit(
                    "ANA002", node,
                    f"`{chain}(...)` without device=: the tensor lands on "
                    f"the CPU whatever device the program runs on")

        # ANA003: host syncs
        if not self._host_exempt():
            msg = (f"host sync `{chain or leaf}` outside the sanctioned "
                   f"sync points (baseline) stalls the device pipeline")
            if chain.endswith("cuda.synchronize") and root in \
                    self.torch_aliases:
                self._emit("ANA003", node, msg)
            elif isinstance(node.func, ast.Attribute) and not node.args:
                if leaf in TORCH_SYNC_METHODS:
                    self._emit("ANA003", node, msg)
                elif leaf in SHARED_SYNC_METHODS and self._frames:
                    self._frames[-1].torch_only_syncs.append((node, msg))
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in CAST_BUILTINS \
                    and len(node.args) == 1 and self._frames \
                    and self._torch_value(node.args[0]):
                self._frames[-1].torch_only_syncs.append((
                    node, f"host sync `{node.func.id}(...)` of a tensor "
                          f"outside the sanctioned sync points (baseline)"))
        self.generic_visit(node)


def _iter_py_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _is_device_path(relpath: str) -> bool:
    parts = relpath.replace(os.sep, "/").split("/")
    return any(d in parts[:-1] for d in DEVICE_PATH_DIRS)


def lint_source(src: str, relpath: str) -> List[Finding]:
    """Lint one module's source; `relpath` places it (its directories
    decide whether it is a device path)."""
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError as e:
        return [Finding(rule="ANA000", path=relpath,
                        line=e.lineno or 0, symbol="<module>",
                        message=f"syntax error: {e.msg}")]
    v = _Visitor(relpath, relpath, _is_device_path(relpath))
    v.visit(tree)
    return sorted(v.findings, key=lambda f: (f.line, f.rule, f.message))


def lint_file(path: str, relpath: Optional[str] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), relpath or path)


def run_lint(paths: Sequence[str]) -> List[Finding]:
    """Lint files/trees; paths in findings are relative to the cwd."""
    findings: List[Finding] = []
    for p in paths:
        files = _iter_py_files(p) if os.path.isdir(p) else [p]
        for fp in files:
            findings.extend(lint_file(fp, os.path.relpath(fp)))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[dict]:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return list(data.get("suppressions", data) if isinstance(data, dict)
                else data)


def _baseline_matches(entry: dict, finding: Finding) -> bool:
    if entry.get("rule") != finding.rule:
        return False
    bpath = entry.get("path", "").replace("\\", "/")
    fpath = finding.path.replace("\\", "/")
    if not (fpath == bpath or fpath.endswith("/" + bpath)):
        return False
    sym = entry.get("symbol", "*")
    return sym == "*" or sym == finding.symbol


def apply_baseline(
    findings: Sequence[Finding], baseline: Sequence[dict],
) -> Tuple[List[Finding], List[Finding]]:
    """Split into (new, suppressed)."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if any(_baseline_matches(e, f) for e in baseline):
            suppressed.append(f)
        else:
            new.append(f)
    return new, suppressed
