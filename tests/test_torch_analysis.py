"""The port's static analysis (`repro_torch.analysis`) on the CPU.

Ranges: the port's `Interval` against the reference's
(`repro.analysis.ranges.Interval`, pure Python) on seeded random
operations; the derived constants against the reference's and both
packages' `core/bfs.py`; the seeded-bug witnesses flagged and their
guarded forms clean; the port's own packs clean at the largest n it
takes. The reference's `propagate` / `check_ranges` and its jaxpr audit
are not called: they need JAX API that this JAX no longer has.

Lint: one fixture source per rule that flags and one that is clean,
baseline suppression, and the shipped tree clean modulo `baseline.json`
(with no stale entry).

Audit: the CLI run on the tree (exit 0, every standard program within
its sync budget at n = 64, no wide dtype outside its allowance), an
injected `.item()` inside a port function flagged at its site, a float64
leak flagged, a card-only site that syncs on the CPU flagged, the
service's signatures within budget, and the CLI's exit codes 1 and 2.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import graph_audit as ga
from repro_torch.analysis import lint, ranges
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core import bfs
from repro_torch.core import sparsify as sp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
I = ranges.Interval


# ------------------------------------------------------------- ranges

def _rand_interval(rng, ref_cls):
    lo = int(rng.integers(-2 ** 40, 2 ** 40))
    hi = lo + int(rng.integers(0, 2 ** 40))
    sent = [None, ranges.INT32_MAX, -1][int(rng.integers(0, 3))]
    if rng.random() < 0.1:
        return ref_cls.top(), ranges.Interval.top()
    return (ref_cls.of(lo, hi, sentinel=sent),
            ranges.Interval.of(lo, hi, sentinel=sent))


def _same(a, b):
    return (a.unknown == b.unknown and a.sentinel == b.sentinel
            and (a.unknown or (a.lo == b.lo and a.hi == b.hi)))


@pytest.mark.parametrize("seed", range(4))
def test_interval_matches_reference_on_seeded_operations(seed):
    from repro.analysis.ranges import Interval as RefInterval

    rng = np.random.default_rng(seed)
    dtypes = ("int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64", "float32")
    for _ in range(300):
        (ra, pa), (rb, pb) = (_rand_interval(rng, RefInterval)
                              for _ in range(2))
        for op in ("__add__", "__sub__", "__mul__", "min_", "max_",
                   "union"):
            assert _same(getattr(pa, op)(pb), getattr(ra, op)(rb)), op
        c = int(rng.integers(-1000, 1000))
        assert _same(pa + c, ra + c) and _same(pa * c, ra * c)
        assert _same(pa.neg(), ra.neg())
        assert _same(pa.hull_with_sentinel(), ra.hull_with_sentinel())
        assert pa.taints_float() == ra.taints_float()
        for dt in dtypes:
            assert pa.fits(dt) == ra.fits(np.dtype(dt))
            assert pa.fits(getattr(torch, dt, dt)) == ra.fits(np.dtype(dt))


def test_derived_constants_equal_reference_and_bfs():
    from repro.analysis import ranges as rref
    from repro.core import bfs as jbfs

    assert ranges.derive_packed_key_max_n() == \
        rref.derive_packed_key_max_n() == bfs.PACKED_KEY_MAX_N == \
        jbfs.PACKED_KEY_MAX_N
    assert ranges.derive_euler_pack_max_n() == \
        rref.derive_euler_pack_max_n() == bfs.EULER_PACK_MAX_N == \
        jbfs.EULER_PACK_MAX_N
    for n in (2, 1024, bfs.PACKED_KEY_MAX_N):
        assert ranges.packed_key_interval(n).hi == bfs.packed_key_bound(n) \
            == rref.packed_key_interval(n).hi
    assert ga.check_derived_constants() == []


def _i64(k=8):
    return torch.zeros((k,), dtype=torch.int64)


def _i32(k=8):
    return torch.zeros((k,), dtype=torch.int32)


DEPTH = I.of(0, 63, sentinel=bfs.INF)
N1 = bfs.PACKED_KEY_MAX_N + 1
F32 = torch.ones((8,))
BASE = torch.tensor(N1, dtype=torch.int32)


@pytest.mark.parametrize("case", [
    # (name, witness, seeds, args, the kind it flags or None)
    ("inf-depth", lambda d, w: d.to(torch.float32) * w,
     [DEPTH, I.of(0, 1)], (_i64(), F32), "sentinel-escape"),
    ("inf-depth guarded", lambda d, w: bfs.finite_depth(d).to(
        torch.float32) * w, [DEPTH, I.of(0, 1)], (_i64(), F32), None),
    ("effective_weights", lambda u, v, w, d: bfs.effective_weights(
        u, v, w, d, 8), [I.of(0, 7), I.of(0, 7), I.of(0, 1), DEPTH],
     (_i64(), _i64(), F32, _i64()), None),
    ("pack-overflow", lambda d, i, b: d * b + i,
     [I.of(0, N1), I.of(0, N1), I.const(N1 + 1)], (_i32(), _i32(), BASE),
     "int-overflow"),
    ("pack at the switch", lambda d, i, b: d * b + i,
     [I.of(0, N1 - 1), I.of(0, N1 - 1), I.const(N1)],
     (_i32(), _i32(), BASE), None),
    ("narrowing cast", lambda x: x.to(torch.int32), [I.of(0, 2 ** 40)],
     (_i64(),), "cast-overflow"),
    ("unmodelled op is TOP", lambda x: torch.cumprod(x, 0) * x,
     [I.of(0, 2 ** 40)], (_i64(),), None),
    ("written input is TOP", lambda x: x.add_(2 ** 40) * 2 ** 30,
     [I.of(0, 1)], (_i64(),), None),
], ids=lambda c: c[0])
def test_witnesses_flag_and_guarded_forms_are_clean(case):
    _, fn, seeds, args, kind = case
    found = ranges.check_ranges(fn, seeds, *args)
    assert [f.kind for f in found] == ([] if kind is None else [kind]), \
        found


def test_port_packs_clean_at_the_largest_n():
    """`bfs.relax_key` (int64, the INF depths' products included) at the
    largest n the port takes, and `bfs.euler_arc_key` read as u32 at the
    switch point; one past it flags, and so does the relax key in int32
    at a small n (its INF sentinel is in every product)."""
    n = ranges.PORT_MAX_N
    live = torch.ones((8,), dtype=torch.bool)
    seeds = [I.of(0, n, sentinel=bfs.INF), I.of(0, n - 1), I.of(0, 1)]
    assert ranges.check_ranges(
        lambda d, s, l: bfs.relax_key(d, s, l, n + 1), seeds, _i64(),
        _i64(), live) == []
    small = [I.of(0, 100, sentinel=bfs.INF), I.of(0, 99), I.of(0, 1)]
    assert ranges.check_ranges(
        lambda d, s, l: bfs.relax_key(d, s, l, 101), small, _i32(),
        _i32(), live)
    for m, flags in ((bfs.EULER_PACK_MAX_N, False),
                     (bfs.EULER_PACK_MAX_N + 1, True)):
        found = ranges.check_ranges(bfs.euler_arc_key,
                                    [I.of(0, m), I.of(0, m)], _i64(), _i64(),
                                    out_dtypes=["uint32"])
        assert bool(found) == flags, (m, found)


# --------------------------------------------------------------- lint

HEAD = "import numpy as np\nimport torch\n\n"
LINT_CASES = {
    "ANA001": (HEAD + "def f(x):\n    return torch.as_tensor(np.sort(x))\n",
               HEAD + "def f_np(x):\n    return torch.as_tensor(np.sort(x))"
               "\n\ndef g(x):\n    return np.sort(x)\n"),
    "ANA002": (HEAD + "def f(n, dev):\n    return torch.arange(n)\n",
               HEAD + "def f(n, dev):\n    return torch.arange("
               "n, dtype=torch.int64, device=dev)\n"),
    "ANA003": (HEAD + "def f(x):\n    while bool(torch.any(x > 0)):\n"
               "        x = x - 1\n    return x\n",
               HEAD + "def f(x):\n    return int(np.argmax(x)) + "
               "len(x.tolist())\n"),
    "ANA004": (HEAD + "def mst(u, v, n):\n    return torch.zeros_like(u)\n",
               HEAD + "def mst(u, v, n, edge_valid):\n"
               "    return torch.zeros_like(u)\n"),
    "ANA005": (HEAD + "def f(x):\n    try:\n        return torch.sort(x)\n"
               "    except RuntimeError:\n        return x\n",
               HEAD + "def f(x):\n    try:\n        return torch.sort(x)\n"
               "    except RuntimeError as e:\n"
               "        raise ValueError('no sort') from e\n"),
}


@pytest.mark.parametrize("flags", [True, False], ids=["flags", "clean"])
@pytest.mark.parametrize("rule", sorted(LINT_CASES))
def test_lint_rule_fixture(rule, flags):
    src = LINT_CASES[rule][0 if flags else 1]
    found = lint.lint_source(src, "src/repro_torch/core/fixture.py")
    assert [f.rule for f in found] == ([rule] * len(found) if flags
                                       else []), found
    assert bool(found) == flags
    # outside a device path only the sync rule applies
    off = lint.lint_source(src, "src/repro_torch/models/fixture.py")
    assert [f.rule for f in off] == ([rule] if flags and rule == "ANA003"
                                     else [])


def test_lint_ana002_flags_a_factory_without_device():
    found = lint.lint_source(
        HEAD + "def f(n):\n    return torch.zeros((n,), dtype=torch.int64)"
        "\n", "src/repro_torch/kernels/fixture.py")
    assert [(f.rule, "device=" in f.message) for f in found] == [
        ("ANA002", True)]


def test_baseline_suppresses_by_rule_path_and_symbol():
    found = lint.lint_source(LINT_CASES["ANA003"][0],
                             "src/repro_torch/core/fixture.py")
    entry = dict(rule="ANA003", path="repro_torch/core/fixture.py",
                 symbol="f", reason="x")
    assert lint.apply_baseline(found, [entry]) == ([], found)
    for other in (dict(entry, symbol="g"), dict(entry, rule="ANA001"),
                  dict(entry, path="core/other.py")):
        assert lint.apply_baseline(found, [other]) == (found, [])
    assert lint.apply_baseline(found, [dict(entry, symbol="*")])[0] == []


def test_shipped_tree_is_clean_modulo_the_baseline():
    found = lint.run_lint([os.path.join(SRC, "repro_torch")])
    base = lint.load_baseline()
    new, suppressed = lint.apply_baseline(found, base)
    assert new == [], "\n".join(f.format() for f in new)
    assert all(e["reason"] for e in base)
    stale = [e for e in base
             if not any(lint._baseline_matches(e, f) for f in suppressed)]
    assert stale == []


# -------------------------------------------------------------- audit

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """`python -m repro_torch.analysis --device cpu --json` on the tree,
    once."""
    out = tmp_path_factory.mktemp("analysis") / "report.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--json", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    return proc, json.loads(out.read_text())


def test_cli_on_the_tree_exits_0(cli_run):
    proc, report = cli_run
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert report["ok"] and report["lint"] == []
    assert report["derived_constants"] == []


def test_standard_programs_within_budget_at_n64(cli_run):
    _, report = cli_run
    audits = {a["name"]: a for a in report["audits"]}
    assert len(audits) == 12
    for name, a in audits.items():
        assert a["ok"], (name, a["findings"])
        assert set(a["bounds"]) == {ga.site_key(s) for s in a["syncs"]}
    # every fused program on the CPU runs the plain MARK loop, and the
    # card-only REC read never syncs here
    for name in ("lgrass_device[doubling]", "lgrass_device[levels]"):
        keys = {ga.site_key(s) for s in audits[name]["syncs"]}
        assert "core/marking.py:phase1_chunked" in keys
        assert "core/recovery.py:_recover_scan" in keys
        assert "kernels/phase1.py:recover_cuda" not in keys
    assert audits["probe_edge_resistance"]["n_syncs"] == 0


def _graph(n=32, L=64):
    u, v, w, _ = ga.audit_graphs(n, L, 1, seed=3)
    return u[0], v[0], w[0], n


def test_injected_item_is_flagged_at_its_site(monkeypatch):
    u, v, w, n = _graph()
    budget = ga.budget_for("phase1", "doubling")
    clean = ga.audit_program("phase1", sp.phase1_device, (u, v, w, n),
                             budget=budget, ctx=ga.Ctx(n=n, L=64, ecc=n))
    assert clean.ok, clean.findings
    finite = bfs.finite_depth

    def with_item(depth):
        depth.max().item()
        return finite(depth)

    monkeypatch.setattr(bfs, "finite_depth", with_item)
    rep = ga.audit_program("phase1", sp.phase1_device, (u, v, w, n),
                           budget=budget, ctx=ga.Ctx(n=n, L=64, ecc=n))
    assert not rep.ok
    assert any("core/bfs.py:effective_weights" in f for f in rep.findings)
    assert rep.n_syncs == clean.n_syncs + 1


def test_sync_over_its_bound_or_on_the_wrong_device_is_flagged():
    u, v, w, n = _graph()
    tight = {"core/bfs.py:bfs_doubling": ga.Allow(lambda c: 1, "one")}
    rep = ga.audit_program("bfs", bfs.bfs_doubling,
                           (u, v, n, torch.tensor(0)), budget=tight,
                           ctx=ga.Ctx(n=n, L=64))
    assert any("over its bound 1" in f for f in rep.findings)
    card = {"core/bfs.py:bfs_doubling": ga.Allow(lambda c: 99, "card",
                                                 "cuda")}
    rep = ga.audit_program("bfs", bfs.bfs_doubling,
                           (u, v, n, torch.tensor(0)), budget=card,
                           ctx=ga.Ctx(n=n, L=64))
    assert any("site of the card's route" in f for f in rep.findings)


def test_float64_leak_is_flagged():
    u, v, w, n = _graph()
    depth = torch.zeros((n,), dtype=torch.int64)
    assert ga.audit_program("eff", bfs.effective_weights,
                            (u, v, w, depth, n)).ok
    rep = ga.audit_program("eff", bfs.effective_weights,
                           (u, v, w.double(), depth, n))
    assert any("float64" in f and "effective_weights" in f
               for f in rep.findings)


def test_audit_service_signatures_within_budget():
    from repro_torch.serve.sparsify_service import SparsifyService

    svc = SparsifyService(parallel=False, device="cpu")
    reports = ga.audit_service(svc, sizes=[(20, 40)], batch_sizes=(2,))
    assert len(reports) == 1 and reports[0].ok, reports[0].findings
    assert reports[0].n_syncs > 0


def test_audit_sparsify_within_budget():
    """The host-facing entry: `lgrass_sparsify` with its result decode,
    against the 'sparsify' budget (the plain MARK / REC loops on the
    CPU), its bounds from the graph's eccentricity and its tree's depth."""
    from repro_torch.core.graph import random_connected_graph

    rep = ga.audit_sparsify(random_connected_graph(64, 64, seed=5),
                            device="cpu")
    assert rep.ok, rep.findings
    keys = rep.by_key()
    assert keys["core/sparsify.py:results_to_host"] == 2
    assert "kernels/phase1.py:recover_cuda" not in keys


def test_audit_runs_on_the_card_unless_asked(tmp_path, monkeypatch, capsys):
    """With no `device` the audit entry points and the CLI ask for the
    CUDA device; without one they fail instead of auditing the CPU's
    plain loops."""
    from repro_torch.core.graph import random_connected_graph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ga.standard_program_audits()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ga.audit_sparsify(random_connected_graph(16, 4, seed=0))
    (tmp_path / "ok.py").write_text("x = 1\n")
    assert cli_main([str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert cli_main([str(tmp_path), "--skip-audit"]) == 0


@pytest.mark.parametrize("bug", ["inf-depth", "pack-overflow"])
def test_cli_seeded_bug_exits_2(bug, capsys):
    assert cli_main(["--seed-bug", bug]) == 2
    assert "CAUGHT" in capsys.readouterr().out


def test_cli_new_finding_exits_1(tmp_path, capsys):
    core = tmp_path / "repro_torch" / "core"
    core.mkdir(parents=True)
    (core / "new.py").write_text(LINT_CASES["ANA003"][0])
    assert cli_main([str(tmp_path), "--skip-audit"]) == 1
    assert "ANA003" in capsys.readouterr().out
    (core / "new.py").write_text(LINT_CASES["ANA003"][1])
    assert cli_main([str(tmp_path), "--skip-audit"]) == 0
