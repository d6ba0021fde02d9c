"""The port's host layer against the JAX package, and its boundaries.

Graph generators and the numpy baseline oracle of `repro_torch` must
give the same arrays (exact equality) as `repro.core`'s; the package
must never import JAX or `repro`; and its entry point must not drop to
the CPU when no CUDA device is there.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import graph as jgraph

import repro_torch.core as tcore
from repro_torch.core import graph as tgraph

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _assert_same_graph(a, b):
    assert a.n == b.n
    for name in ("u", "v", "w"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("weight", ["lognormal", "uniform", "ties"])
def test_random_connected_graph_matches_reference(seed, weight):
    _assert_same_graph(
        tgraph.random_connected_graph(50, 80, seed=seed, weight=weight),
        jgraph.random_connected_graph(50, 80, seed=seed, weight=weight))


@pytest.mark.parametrize("n,chords,span", [(96, 48, 8), (96, 0, 4),
                                           (4096, 2048, 24)])
def test_feeder_like_graph_matches_reference(n, chords, span):
    _assert_same_graph(
        tgraph.feeder_like_graph(n, chords, span=span, seed=1),
        jgraph.feeder_like_graph(n, chords, span=span, seed=1))


def test_powergrid_and_trivial_graph_match_reference():
    _assert_same_graph(tgraph.powergrid_like_graph(9, 0.4, seed=2),
                       jgraph.powergrid_like_graph(9, 0.4, seed=2))
    _assert_same_graph(tgraph.trivial_graph(), jgraph.trivial_graph())


@pytest.mark.parametrize("name", ["case1", "case2", "case3"])
def test_official_cases_match_reference(name):
    assert tgraph.OFFICIAL_CASE_SHAPES[name] == \
        jgraph.OFFICIAL_CASE_SHAPES[name]
    _assert_same_graph(tgraph.official_case(name), jgraph.official_case(name))


def test_from_reference_round_trips():
    jg = jgraph.random_connected_graph(30, 40, seed=5)
    tg = tgraph.from_reference(jg)
    assert isinstance(tg, tgraph.Graph)
    _assert_same_graph(tg, jg)
    back = jgraph.Graph(n=tg.n, u=tg.u, v=tg.v, w=tg.w)
    _assert_same_graph(tgraph.from_reference(back), tg)
    tg.u[0] = -1  # a copy: the reference graph is untouched
    assert jg.u[0] != -1


@pytest.mark.parametrize("make", [
    lambda m: m.random_connected_graph(45, 90, seed=1, weight="ties"),
    lambda m: m.feeder_like_graph(120, 60, span=8, seed=2),
    lambda m: m.powergrid_like_graph(9, 0.4, seed=3),
    lambda m: m.official_case("case1"),
])
def test_baseline_sparsify_matches_reference(make):
    tg, jg = make(tgraph), make(jgraph)
    for budget in (None, 3):
        t = tcore.baseline_sparsify(tg, budget=budget)
        j = jcore.baseline_sparsify(jg, budget=budget)
        assert np.array_equal(t.edge_mask, j.edge_mask)
        assert np.array_equal(t.accepted, j.accepted)
        assert np.array_equal(t.crit.view(np.int32), j.crit.view(np.int32))
    assert tcore.default_budget(tg.n) == jcore.default_budget(jg.n)


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.kernels.ref\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_never_import_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_lgrass_sparsify_refuses_to_drop_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tgraph.random_connected_graph(20, 20, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.lgrass_sparsify(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.lgrass_sparsify(g, device="cuda")
