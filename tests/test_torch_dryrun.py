"""The port's dry-run tools against the JAX package, on the CPU:
`launch/specs.py`, `launch/dryrun.py` (`n_active_params`,
`model_flops`, `run_cell`, `run_lgrass_cell`, the CLI's cells) and
`launch/mesh.make_production_mesh`.

The reference's specs need meshes of 8 devices, so one subprocess with
8 host devices (as tests/test_distributed.py runs them) writes them all
as JSON; the port's meshes repeat the meta device. Every comparison here
is exact.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_lm import port_cfg
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.distributed import Mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.models.model import LM

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH_NAMES = sorted(tconfigs.ARCHS)
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN = ShapeConfig("t", 64, 8, "train")
DECODE = ShapeConfig("d", 4096, 8, "decode")

_REFERENCE_SPECS = r"""
import json, sys
import jax
from repro import compat
from repro.configs import ARCHS
from repro.configs.base import ShapeConfig
from repro.launch import specs as S
from repro.models.model import LM

def spec(x):
    return [list(e) if isinstance(e, tuple) else e for e in x.sharding.spec]

def tree(t):
    if isinstance(t, dict):
        return {k: tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [tree(v) for v in t]
    return [list(t.shape), spec(t)]

meshes = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
train = ShapeConfig("t", 64, 8, "train")
decode = ShapeConfig("d", 4096, 8, "decode")
out = {}
for mname, (shape, axes) in meshes.items():
    mesh = compat.make_mesh(shape, axes)
    for name, cfg0 in ARCHS.items():
        cfg = cfg0.reduced()
        model = LM(cfg)
        rec = dict(batch=tree(S.batch_specs(cfg, train, mesh)),
                   state=tree(S.state_specs(model, mesh)[0]),
                   params=tree(S.params_specs(model, mesh)[0]),
                   params_resident=tree(S.params_specs(model, mesh,
                                                       fsdp=False)[0]))
        if cfg.supports_decode:
            rec["caches"] = tree(S.cache_specs(model, decode, mesh))
            rec["token"] = tree(S.decode_token_specs(cfg, decode, mesh))
        out[f"{mname}/{name}"] = rec
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    pytest.importorskip("jax")
    path = tmp_path_factory.mktemp("specs") / "ref.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _REFERENCE_SPECS, str(path)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


def _norm(spec) -> tuple:
    """A spec as a tuple, trailing Nones dropped (they replicate)."""
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _port(leaf) -> tuple:
    return tuple(leaf.shape), _norm(leaf.spec)


def _ref(entry, drop_stack: bool = False) -> tuple:
    shape, spec = entry
    if drop_stack:
        assert spec[0] is None
        return tuple(shape[1:]), _norm(spec[1:])
    return tuple(shape), _norm(spec)


def _ref_params(node, n_layers: int) -> dict:
    """The reference's parameter tree as {port name: (shape, spec)}, the
    scan layout's stacked layers split into per-layer leaves."""
    out = {}

    def walk(prefix, x, drop):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}" if prefix else k, v, drop)
        else:
            out[prefix] = _ref(x, drop)

    walk("", {k: v for k, v in node.items() if k != "layers"}, False)
    layers = node["layers"]
    for i in range(n_layers):
        if isinstance(layers, dict):
            walk(f"layers.{i}", layers, True)
        else:
            walk(f"layers.{i}", layers[i], False)
    return out


def _ref_caches(node, n_layers: int) -> list:
    def walk(x, drop):
        if isinstance(x, dict):
            return {k: walk(v, drop) for k, v in x.items()}
        return _ref(x, drop)

    if isinstance(node, dict):
        return [walk(node, True) for _ in range(n_layers)]
    return [walk(x, False) for x in node]


def _port_tree(t):
    if isinstance(t, dict):
        return {k: _port_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_port_tree(v) for v in t]
    return _port(t)


def _meta_mesh(shape, axes) -> Mesh:
    return Mesh((torch.device("meta"),) * int(np.prod(shape)), axes, shape)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_match_reference(ref_specs, name, mesh_name):
    want = ref_specs[f"{mesh_name}/{name}"]
    cfg = port_cfg(_reference_reduced(name))
    mesh = _meta_mesh(*MESHES[mesh_name])
    model = LM(cfg, device="meta")
    assert _port_tree(S.batch_specs(cfg, TRAIN, mesh)) == {
        k: _ref(v) for k, v in want["batch"].items()}
    got_params = {k: _port(v) for k, v in
                  S.params_specs(model, mesh)[0].items()}
    assert got_params == _ref_params(want["params"], cfg.n_layers)
    got_res = {k: _port(v) for k, v in
               S.params_specs(model, mesh, fsdp=False)[0].items()}
    assert got_res == _ref_params(want["params_resident"], cfg.n_layers)
    state, _ = S.state_specs(model, mesh)
    for part in ("mu", "nu"):
        assert {k: _port(v) for k, v in state["opt"][part].items()} == \
            _ref_params(want["state"]["opt"][part], cfg.n_layers)
    assert {k: _port(v) for k, v in state["params"].items()} == \
        _ref_params(want["state"]["params"], cfg.n_layers)
    assert _port(state["opt"]["step"]) == _ref(want["state"]["opt"]["step"])
    assert all(v.dtype == torch.float32 for v in state["params"].values())
    if cfg.supports_decode:
        assert _port_tree(S.cache_specs(model, DECODE, mesh)) == \
            _ref_caches(want["caches"], cfg.n_layers)
        tok, pos = S.decode_token_specs(cfg, DECODE, mesh)
        assert [_port(tok), _port(pos)] == [_ref(x) for x in want["token"]]


def _reference_reduced(name):
    from repro import configs as jconfigs

    return jconfigs.ARCHS[name].reduced()


def test_spec_blocks_are_the_first_entrys():
    mesh = _meta_mesh((4, 2), ("data", "model"))
    leaf = S.leaf((10, 6), torch.float32, mesh, ("data", "model"))
    assert leaf.block == (3, 3) and leaf.nbytes == 240
    assert S.leaf((), torch.int32, mesh, ()).block == ()


def _reference_dryrun():
    """`repro.launch.dryrun` imported without its device-count flag
    reaching JAX (it sets XLA_FLAGS when imported)."""
    pytest.importorskip("jax")
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_active_params_and_model_flops_match_reference(name):
    jd = _reference_dryrun()
    from repro import configs as jconfigs

    jcfg = jconfigs.ARCHS[name]
    cfg = tconfigs.ARCHS[name]
    for padded in (False, True):
        a = jcfg.padded_for_mesh(16) if padded else jcfg
        b = cfg.padded_for_mesh(M.TP_SIZE) if padded else cfg
        assert D.n_active_params(b) == jd.n_active_params(a)
        for shape in tconfigs.SHAPES:
            assert D.model_flops(b, tconfigs.SHAPES[shape]) == \
                jd.model_flops(a, jconfigs.SHAPES[shape])


def test_production_mesh_is_the_references_cell():
    for multi, (shape, axes) in ((False, ((16, 16), ("data", "model"))),
                                 (True, ((2, 16, 16),
                                         ("pod", "data", "model")))):
        mesh = M.make_production_mesh(multi_pod=multi)
        assert mesh.axis_sizes == shape and mesh.axis_names == axes
        assert {d.type for d in mesh.devices} == {"meta"}
    single = M.make_production_mesh()
    assert M.TP_SIZE == single.shape["model"]
    assert M.axis_bandwidth(single, ("data",)) == M.CROSS_NODE_BW
    assert M.axis_bandwidth(_meta_mesh((2, 8), ("data", "model")),
                            ("model",)) == M.NVLINK_BW
    assert M.batch_axes_for(256, M.make_production_mesh(multi_pod=True)) \
        == ("pod", "data")


@pytest.fixture
def small_production_mesh(monkeypatch):
    """The production mesh shrunk to 8 entries, as the reference's
    test_reduced_mesh_dryrun_machinery shrinks it."""
    monkeypatch.setattr(M, "make_production_mesh", lambda multi_pod=False:
                        _meta_mesh(*MESHES["2x2x2" if multi_pod else "4x2"]))


def test_run_cell_on_a_reduced_mesh(small_production_mesh, tmp_path):
    """The twin of the reference's test_reduced_mesh_dryrun_machinery:
    mamba2 train_4k on (2, 2, 2), granite decode_32k on (4, 2) and
    lgrass case1 on (2, 2, 2), at full width."""
    rec1 = D.run_cell("mamba2-370m", "train_4k", True, str(tmp_path),
                      force=True, micro_batches=2)
    assert rec1["flops_per_device"] > 0
    assert rec1["collective_bytes_per_device"] > 0
    assert rec1["devices_with_work"] == 4 and rec1["local_rows"] == 32
    assert rec1["peak_bytes_per_device"] > 0 and rec1["fits"] in (True,
                                                                  False)
    rec2 = D.run_cell("granite-moe-3b-a800m", "decode_32k", False,
                      str(tmp_path), force=True)
    assert rec2["memory"]["peak_bytes"] > 0
    assert rec2["memory"]["host_syncs"] == 0
    rec3 = D.run_lgrass_cell("case1_4k", True, str(tmp_path), force=True)
    assert rec3["bytes_per_device"] > 0 and rec3["local_slots"] == 1632
    # no attention on these paths: the kernels' work is the formulas' count
    for rec in (rec1, rec2, rec3):
        assert rec["flops_work_per_device"] == rec["flops_per_device"]
    # the reference's layout: the first entry's blocks of the specs
    cfg = tconfigs.get_arch("mamba2-370m").padded_for_mesh(M.TP_SIZE)
    mesh = M.make_production_mesh(multi_pod=True)
    state = S.state_specs(LM(cfg, device="meta"), mesh)[0]
    leaves = [x for x in torch.utils._pytree.tree_leaves(state)
              if isinstance(x, S.LeafSpec)]
    leaves += list(S.batch_specs(cfg, tconfigs.SHAPES["train_4k"],
                                 mesh).values())
    held = sum(int(np.prod(x.block)) * x.dtype.itemsize for x in leaves)
    assert rec1["reference_layout_bytes_per_device"] == held
    assert held < sum(x.nbytes for x in leaves)
    for rec in (rec1, rec2, rec3):
        saved = json.loads((tmp_path / f"{rec['cell']}.json").read_text())
        assert saved["cell"] == rec["cell"]
        assert saved["device"]["name"] == M.DEVICE_NAME


def test_cells_skip_and_refuse_with_their_reasons(small_production_mesh,
                                                  tmp_path):
    rec = D.run_cell("phi3-mini-3.8b", "long_500k", False, str(tmp_path))
    assert rec["skipped"] == tconfigs.cell_skip_reason(
        tconfigs.ARCHS["phi3-mini-3.8b"], tconfigs.SHAPES["long_500k"])
    # granite's 24 heads padded to 32 over d_model 1536: head dim 48
    rec = D.run_cell("granite-moe-3b-a800m", "prefill_32k", False,
                     str(tmp_path))
    assert "head dim 48" in rec["cannot_run"]
    assert D.summary_line(rec).startswith("| granite")


def test_cli_writes_a_record_per_cell(small_production_mesh, tmp_path,
                                      capsys):
    D.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--out",
            str(tmp_path), "--mesh", "both"])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["mamba2-370m_decode_32k_h100x256.json",
                     "mamba2-370m_decode_32k_h100x512.json"]
    assert "0 failures" in capsys.readouterr().out


def _local_layout_before(gstart, active):
    """`core.distributed._local_layout` as it was written with boolean
    indexing, the yardstick of its shape-static form."""
    m = gstart.shape[0]
    iota = torch.arange(m, dtype=torch.int64)
    start = torch.where(active, gstart.to(torch.int64), active.sum())
    head = start == iota
    gidx = torch.cumsum(head.to(torch.int64), dim=0) - 1
    group_start = torch.full((m,), m, dtype=torch.int64)
    group_start[gidx[head]] = iota[head]
    return gidx, group_start, head


@pytest.mark.parametrize("seed", range(4))
def test_shape_static_rewrites_are_bit_equal(seed):
    from repro_torch.core.distributed import _local_layout
    from repro_torch.core.sort import bucket_ranks

    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 6, 12)
    gstart = np.concatenate([np.full(s, o) for s, o in
                             zip(sizes, np.cumsum(sizes) - sizes)])
    pad = int(rng.integers(0, 5))
    gstart = torch.from_numpy(np.concatenate([gstart, np.zeros(pad)])
                              .astype(np.int32))
    active = torch.arange(gstart.shape[0]) < int(sizes.sum())
    layout, head = _local_layout(gstart, active)
    gidx, group_start, want_head = _local_layout_before(gstart, active)
    assert torch.equal(layout.gidx, gidx) and torch.equal(head, want_head)
    assert torch.equal(layout.group_start, group_start)
    keys = torch.from_numpy(rng.integers(0, 300, 700))
    order = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys, minlength=300)
    starts = torch.cumsum(counts, 0) - counts
    want = torch.empty_like(order)
    want[order] = torch.arange(700) - starts[keys[order]]
    assert torch.equal(bucket_ranks(keys, 300), want.to(torch.int32))


def test_lgrass_cell_traces_the_mark_operator(small_production_mesh,
                                              tmp_path):
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    rec = D.run_lgrass_cell("case2_7k", False, str(tmp_path), force=True)
    assert rec["devices_with_work"] == 8 and rec["fits"]
    assert rec["collectives"]["n_tables->shards"] == 7
    assert ops.launch_counts()["mark"] == 0   # a fake launches nothing


def test_tp_cells_trace_one_working_entry(small_production_mesh, tmp_path):
    """On the (4, 2) test mesh a GQA cell is tensor parallel: granite's
    decode_32k traces one entry at its blocks (its 48 experts padded for
    16 ways, 24 an entry on a 'model' extent of 2), every one of the 8
    entries works, and its collective term holds the 'model' reductions
    by kind at the NVLink rate; mamba2 (SSM) keeps its 4 data shards and
    no 'model' term. The traced entry is the port's own layout: its
    leaves are entry 0's blocks of `place_model` on a real CPU mesh of
    the same 'model' extent, and the bytes of the state that a CPU
    (2, 4) mesh step holds on entry 0 (parameters, mu, nu, the
    accumulator's tiles) equal those of the traced entry's state."""
    rec = D.run_cell("granite-moe-3b-a800m", "decode_32k", False,
                     str(tmp_path), force=True)
    assert rec["devices_with_work"] == 8 and rec["model_entries"] == 2
    assert rec["model_collective_bytes_per_device"] > 0
    assert rec["state_layout"] == "entry blocks"
    assert not any(k.startswith("port_root") for k in rec)
    kinds = {k for k in rec["collectives"] if k.startswith("model:")}
    assert kinds == {"model:embed", "model:attn_out", "model:moe_combine",
                     "model:logits"}
    layers = tconfigs.get_arch("granite-moe-3b-a800m").n_layers
    assert rec["collectives"]["n_model:attn_out"] == layers  # one a layer
    mesh = M.make_production_mesh()
    assert rec["t_collective_s"] == pytest.approx(
        rec["model_collective_bytes_per_device"]
        / M.axis_bandwidth(mesh, ("model",)))
    ssm = D.run_cell("mamba2-370m", "decode_32k", False, str(tmp_path),
                     force=True)
    assert ssm["devices_with_work"] == 4 and ssm["model_entries"] == 1
    assert ssm["model_collective_bytes_per_device"] == 0
    assert ssm["state_layout"] == "whole leaves"
    from repro_torch.models import sharding as sh
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train import train_step as tts

    cpu = torch.device("cpu")
    for name, tp in (("granite-moe-3b-a800m", 2), ("phi3-mini-3.8b", 4)):
        cfg = tconfigs.get_arch(name).reduced()
        traced, entry = D._meta_model(cfg, tp, param_dtype=torch.float32)
        real = Mesh((cpu,) * 8, ("data", "model"), (8 // tp, tp))
        model = sh.place_model(
            LM(cfg, generator=torch.Generator().manual_seed(0),
               device="cpu", param_dtype=torch.float32), real)
        got = dict(sh.named_leaves(traced))
        assert list(got) == [n for n, _ in sh.named_leaves(model)]
        for n, leaf in sh.named_leaves(model):
            if isinstance(leaf, sh.Placed):
                assert isinstance(got[n], sh.Placed), n
                assert got[n].shards[0].shape == leaf.shards[0].shape, n
                assert got[n].block(0) == leaf.block(0), n
            else:
                assert got[n].shape == leaf.shape, n
        if tp != 4:
            continue
        # entry 0's bytes in a (2, 4) step, and the traced entry's
        with sh.use_mesh(real):
            state = tts.make_train_state(model)
            held = tts.entry_bytes(model, state, rows=8)
        tstate = tts.make_train_state(traced)
        with sh.use_entries(entry):
            want = tts.entry_bytes(traced, tstate, rows=4)
        assert held[0] == want[0] and want[0]["accumulator"] > 0
        assert held[0]["params"] == held[0]["mu"] == held[0]["nu"]
        # the other entries hold their blocks alone; the accumulator's
        # tiles are kept by data shard 0's entries
        assert all(h["params"] < held[0]["params"] for h in held[1:])
        assert all(h["accumulator"] == 0 for h in held[4:])
        with sh.use_entries(entry):
            tts.make_train_step(traced, OptConfig())(
                tstate, D._meta_batch(cfg, 4, 8))
