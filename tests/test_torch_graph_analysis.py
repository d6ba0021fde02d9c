"""`launch.graph_analysis.analyze_program` against the JAX package's
`launch.hlo_analysis.analyze_jitted`, on the CPU, and the kernels'
operators (`kernels/oplib.py`): their fakes and FLOP formulas.

The twins of tests/test_hlo_jitted.py and of
tests/test_attention_paths.py::test_hlo_analyzer_trip_counts, then the
FLOPs of reduced phi3 and mamba2 train and prefill steps: the port's
count on meta tensors (the card's route, through the operators' fakes)
equals its count on CPU tensors (the plain versions) exactly, and the
reference's HLO count within 2% (exactly, where the test says which
products the reference's HLO leaves out).
"""
import pytest
import torch

from _torch_lm import port_cfg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, radix_hist
from repro_torch.launch.graph_analysis import analyze_program
from repro_torch.models.model import LM
from repro_torch.optim.optimizer import OptConfig as TOptConfig
from repro_torch.train import train_step as tts

META = torch.device("meta")
FLOP_RTOL = 0.02
B, SEQ = 4, 64


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.launch import hlo_analysis
    from repro.models.model import LM as JLM
    from repro.optim.optimizer import OptConfig
    from repro.serve.serve_step import make_prefill_step
    from repro.train.train_step import make_train_state, make_train_step

    jax.clear_caches()
    yield types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=configs, hla=hlo_analysis, LM=JLM,
        OptConfig=OptConfig, make_prefill_step=make_prefill_step,
        make_train_state=make_train_state, make_train_step=make_train_step)
    jax.clear_caches()


@pytest.mark.parametrize("dev", ("cpu", "meta"))
def test_analyze_program_plain_callable(J, dev):
    x = torch.zeros((32, 32), device=dev)
    report = analyze_program(lambda a, b: a @ b, x, x)
    sds = J.jax.ShapeDtypeStruct((32, 32), J.jnp.float32)
    want = J.hla.analyze_jitted(lambda a, b: a @ b, sds, sds)
    assert report["flops"] >= 2 * 32 * 32 * 32
    assert report["flops"] == want["flops"]
    assert report["transfer_count"] == 0 == want["transfer_count"]
    assert report["output_alias"] == [] == want["output_alias"]


def test_analyze_program_with_statics():
    def f(x, scale=2.0):
        return x * scale

    report = analyze_program(f, torch.ones(256), static_kwargs=dict(
        scale=3.0))
    assert report["transfer_count"] == 0 and report["n_ops"] >= 1
    assert torch.equal(report["outputs"], torch.full((256,), 3.0))


def test_written_argument_reports_alias(J):
    """The port's donation: a program that writes its result into an
    argument hands that storage back; the reference's donated jit aliases
    the same parameter."""
    def donated(x, y):
        return x.mul_(2).add_(y)

    x, y = torch.ones(256), torch.ones(256)
    report = analyze_program(donated, x, y)
    sds = J.jax.ShapeDtypeStruct((256,), J.jnp.float32)
    want = J.hla.analyze_jitted(
        J.jax.jit(lambda a, b: a * 2 + b, donate_argnums=(0,)), sds, sds)
    assert [a["parameter"] for a in report["output_alias"]] == \
        [a["parameter"] for a in want["output_alias"]] == [0]
    assert report["output_alias"][0]["kind"] == "must-alias"
    assert report["outputs"].data_ptr() == x.data_ptr()
    plain = analyze_program(lambda a, b: a * 2 + b, torch.ones(256),
                            torch.ones(256))
    assert plain["output_alias"] == []


def test_service_donated_dispatch_aliases_buffers():
    from repro_torch.analysis.graph_audit import audit_graphs
    from repro_torch.serve.sparsify_service import SparsifyService

    svc = SparsifyService(donate=True, device="cpu")
    spec = svc.program_specs([(64, 128)], batch_sizes=(2,))[0]
    assert spec.name.startswith("lgrass_device_batched[donated]")
    (b, L), _ = spec.args[0]
    u, v, w, ev = audit_graphs(spec.static_kwargs["n"], L, b)
    budget = torch.full((b,), spec.signature[3], dtype=torch.int32)
    report = analyze_program(spec.fn, u, v, w, ev, budget,
                             static_kwargs=spec.static_kwargs)
    assert report["transfer_count"] == 0
    assert len(report["output_alias"]) >= 1
    assert {a["parameter"] for a in report["output_alias"]} == {3}
    assert report["peak_bytes"] > 0


def test_report_keys_are_stable():
    report = analyze_program(lambda x: torch.sort(x).values,
                             torch.arange(256.0))
    for key in ("flops", "mem_bytes", "mem_bytes_upper", "mem_bytes_dots",
                "collective_bytes", "collective_by_kind",
                "collective_counts", "transfer_count", "sync_count",
                "output_alias", "entry", "peak_bytes"):
        assert key in report
    assert report["mem_bytes"] == report["mem_bytes_upper"] > 0


def test_host_syncs_and_copies_are_counted_apart():
    def f(x):
        y = x.to("meta")
        return y.sum(), int(x.sum())

    report = analyze_program(f, torch.ones(8))
    assert report["transfer_count"] == 1 and report["sync_count"] == 0


def test_loop_trip_counts(J):
    """The twin of test_hlo_analyzer_trip_counts: a 6-step Python loop
    of tanh(x @ w) counts each step, as the reference's analyzer scales
    its scan's while body by the trip count."""
    def f(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    report = analyze_program(f, torch.empty((64, 128), device=META),
                             torch.empty((6, 128, 128), device=META))
    assert report["flops"] == 6 * 2 * 64 * 128 * 128
    assert report["mem_bytes_dots"] > 0
    assert report["mem_bytes"] <= report["mem_bytes_upper"] + 1e-6

    def body(x, w):
        return J.jnp.tanh(x @ w), None

    x = J.jax.ShapeDtypeStruct((64, 128), J.jnp.float32)
    ws = J.jax.ShapeDtypeStruct((6, 128, 128), J.jnp.float32)
    text = J.jax.jit(lambda x, ws: J.jax.lax.scan(body, x, ws)[0]).lower(
        x, ws).compile().as_text()
    assert J.hla.analyze(text)["flops"] == report["flops"]


def _port_model(cfg, dev, dtype=None):
    model = LM(port_cfg(cfg), device=dev, param_dtype=dtype)
    if dev != "meta":
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def _port_flops(cfg, dev) -> dict:
    model = _port_model(cfg, dev, torch.float32)
    state = tts.make_train_state(model)
    tok = torch.zeros((B, SEQ), dtype=torch.int32, device=dev)
    train = analyze_program(tts.make_train_step(model, TOptConfig()), state,
                            dict(tokens=tok, labels=tok))["flops"]
    serve = _port_model(cfg, dev)
    with torch.no_grad():
        prefill = analyze_program(lambda t, c: serve.prefill(t, c), tok,
                                  serve.init_caches(B, SEQ))["flops"]
    return dict(train=train, prefill=prefill)


def _ref_flops(J, cfg) -> dict:
    m = J.LM(cfg)
    key = J.jax.random.PRNGKey(0)
    tok = J.jax.ShapeDtypeStruct((B, SEQ), J.jnp.int32)
    state = J.jax.eval_shape(lambda r: J.make_train_state(m, r), key)
    train = J.hla.analyze_jitted(J.make_train_step(m, J.OptConfig()), state,
                                 dict(tokens=tok, labels=tok))["flops"]
    params = J.jax.eval_shape(lambda r: m.init(r)[0], key)
    caches = J.jax.eval_shape(lambda: m.init_caches(B, SEQ))
    prefill = J.hla.analyze_jitted(J.make_prefill_step(m), params, tok,
                                   caches)["flops"]
    return dict(train=train, prefill=prefill)


@pytest.mark.parametrize("name", ("phi3-mini-3.8b", "mamba2-370m"))
def test_step_flops_match_reference(J, name):
    cfg = J.configs.ARCHS[name].reduced()
    card = _port_flops(cfg, "meta")
    cpu = _port_flops(cfg, "cpu")
    assert card == cpu       # one count whatever executes the kernels
    want = _ref_flops(J, cfg)
    assert abs(card["train"] / want["train"] - 1) <= FLOP_RTOL
    # The reference's prefill runs its Pallas flash kernel, whose
    # interpret-mode HLO holds no dot that its analyzer counts: the port
    # counts the kernel's two products per attention layer, held apart.
    attn = cfg.n_layers * fa.attention_flops(
        (B, SEQ, cfg.n_heads, cfg.resolved_head_dim), (B, SEQ), 2) \
        if cfg.has_attention else 0
    assert abs((card["prefill"] - attn) / want["prefill"] - 1) <= FLOP_RTOL


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _same_layout(got, want) -> None:
    """got (a fake) has want's shape and dtype, and the stride of want
    made contiguous: every kernel returns contiguous outputs (its
    contract, which chip_smoke.py holds the fakes to on the card), where
    a plain version may return a permuted view."""
    want = want.contiguous()
    assert (got.shape, got.dtype, got.stride()) == \
        (want.shape, want.dtype, want.stride())


# (B, S, H, Kv, d, dtype): phi3's, granite's and hubert's flash shapes in
# chip_smoke.py, and a float32 one
FLASH_SHAPES = ((4, 2048, 32, 32, 96, torch.bfloat16),
                (4, 2048, 24, 8, 64, torch.bfloat16),
                (4, 1500, 16, 16, 80, torch.bfloat16),
                (2, 128, 4, 2, 16, torch.float32))


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_fakes_match_the_plain_version(shape):
    b, s, h, kvh, d, dt = shape
    q, k = _meta(b, s, h, d, dtype=dt), _meta(b, s, kvh, d, dtype=dt)
    pos = torch.arange(s, dtype=torch.int32, device=META)
    plain = fa.flash_attention_plain(q, k, k, pos, pos, True, None)
    _same_layout(fa.FWD_OP(q, k, k, pos, pos, True, None), plain)
    out, lse = fa.FWD_LSE_OP(q, k, k, pos, pos, True, None)
    _same_layout(out, plain)
    _same_layout(lse, fa.flash_attention_lse_plain(q, k, pos, pos, True,
                                                   None))
    grads = fa.BWD_OP(q, q, k, k, q, pos, pos, lse, True, None)
    want = fa.flash_attention_backward_plain(q, q, k, k, pos, pos, True,
                                             None)
    for got, w in zip(grads, want):
        _same_layout(got, w)


@pytest.mark.parametrize("m", (32, 32_768, 65_536))
def test_radix_fakes_match_the_plain_version(m):
    digits = _meta(m, dtype=torch.int32)
    for got, want in zip(radix_hist.RANK_OP(digits),
                         radix_hist.bucket_rank_hist_plain(digits)):
        _same_layout(got, want)
    keys = _meta(m, dtype=torch.int64)
    _same_layout(radix_hist.ARGSORT_OP(keys, None),
                 radix_hist.radix_argsort_plain(keys))
    _same_layout(radix_hist.ARGSORT_OP(keys, keys),
                 radix_hist.radix_argsort_plain(keys, keys))


def test_mark_fake_matches_the_plain_version():
    from test_torch_distributed import _shard_blocks

    from repro_torch.core.distributed import _local_layout
    from repro_torch.core.graph import random_connected_graph
    from repro_torch.core.lca import LiftingTables

    t, blocks = _shard_blocks(random_connected_graph(60, 140, seed=0), 2,
                              32)
    su, sv, sb, gstart, active = blocks[0]
    layout, _ = _local_layout(gstart, active)
    want = ops.mark(t, su, sv, sb, layout, 32, 32)

    def meta(x):
        return torch.empty_like(x, device=META)

    mt = LiftingTables(up=meta(t.up), depth=meta(t.depth))
    mlayout = type(layout)(*(meta(x) for x in layout))
    got = ops.mark(mt, meta(su), meta(sv), meta(sb), mlayout, 32, 32)
    for g, w in zip(got, want):
        _same_layout(g, w)


def test_operators_count_their_flops_and_never_launch_on_meta():
    from torch.utils.flop_counter import FlopCounterMode

    ops.reset_launch_counts()
    q = _meta(2, 64, 4, 32, dtype=torch.bfloat16).requires_grad_(True)
    k = _meta(2, 64, 2, 32, dtype=torch.bfloat16).requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        out = ops.flash_attention(q, k, k)
        torch.autograd.grad(out.float().sum(), (q, k))
    assert counter.get_total_flops() == 12 * 2 * 4 * 64 * 64 * 32
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("sq,sk,causal,window", (
    (64, 64, True, None), (64, 64, False, None), (64, 64, True, 16),
    (64, 64, False, 16), (48, 80, True, None), (80, 48, True, 7),
    (1, 97, True, None), (33, 33, True, 1)))
def test_visible_pairs_count_the_mask(sq, sk, causal, window):
    mask = fa.visible_mask(torch.arange(sq), torch.arange(sk), causal,
                           window)
    assert fa.visible_pairs(sq, sk, causal, window) == int(mask.sum())


@pytest.mark.parametrize("causal,window", ((True, None), (True, 24),
                                           (False, None)))
def test_flops_work_counts_the_kernels_visible_pairs(causal, window):
    """`flops` counts the full square (2 + 4 products), `flops_work` the
    pairs the mask leaves visible (2 + 5 products, S recomputed), as
    chip_smoke.py's kernel bounds count them."""
    b, s, h, d = 2, 64, 4, 32
    q = _meta(b, s, h, d, dtype=torch.bfloat16).requires_grad_(True)
    k = _meta(b, s, 2, d, dtype=torch.bfloat16).requires_grad_(True)

    def step(q, k):
        out = ops.flash_attention(q, k, k, causal=causal, window=window)
        return torch.autograd.grad(out.float().sum(), (q, k))

    report = analyze_program(step, q, k)
    pairs = int(fa.visible_mask(torch.arange(s), torch.arange(s), causal,
                                window).sum())
    attn = report["flops"] - 12 * b * h * s * s * d
    assert attn == 0  # nothing else in the step has a FLOP formula
    assert report["flops_work"] == fa.pair_flops(
        (b, s, h, d), pairs, fa.FWD_PRODUCTS + fa.BWD_PRODUCTS)
    if not causal and window is None:
        assert report["flops_work"] == report["flops"] * 14 // 12


def _remat_train_trace(J):
    import dataclasses

    cfg = dataclasses.replace(J.configs.ARCHS["dbrx-132b"].reduced(),
                              remat=True, dtype="bfloat16", n_layers=4)
    model = _port_model(cfg, "meta", torch.float32)
    tok = torch.zeros((B, SEQ), dtype=torch.int32, device=META)
    return analyze_program(tts.make_train_step(model, TOptConfig(),
                                               micro_batches=2),
                           tts.make_train_state(model),
                           dict(tokens=tok, labels=tok))


def test_traced_peak_does_not_depend_on_the_collector(J, monkeypatch):
    """A traced peak reads the same every run, and the same as a run whose
    cyclic collector runs at every allocation: nothing the trace makes
    outlives its use in a reference cycle (FlopCounterMode's module
    tracker did that under checkpointing, by 6% here)."""
    import gc

    first = _remat_train_trace(J)["peak_bytes"]
    assert _remat_train_trace(J)["peak_bytes"] == first
    threshold = gc.get_threshold()
    monkeypatch.setattr(gc, "disable", lambda: None)
    gc.set_threshold(1)
    try:
        eager = _remat_train_trace(J)["peak_bytes"]
    finally:
        gc.set_threshold(*threshold)
    assert eager == first


def test_a_meta_tensor_at_a_launch_raises():
    d = _meta(8, dtype=torch.int32)
    for launch in (lambda: radix_hist._rank_launch(d),
                   lambda: radix_hist._argsort_launch(d.long(), None)):
        with pytest.raises(RuntimeError, match="fake or meta"):
            launch()
    with pytest.raises(ValueError, match="CUDA"):
        radix_hist._rank_launch(torch.zeros(8, dtype=torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_operators_match_their_fakes_and_count_like_meta(cuda_device):
    """On the card: each operator's outputs have its fake's layout, a
    launch is counted once per call, and a reduced phi3 step counts the
    same FLOPs on CUDA tensors as on meta ones."""
    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(0)
    q = torch.randn((2, 128, 4, 64), generator=gen, device=dev).bfloat16()
    k = torch.randn((2, 128, 2, 64), generator=gen, device=dev).bfloat16()
    pos = torch.arange(128, dtype=torch.int32, device=dev)
    args = (q, k, k, pos, pos, True, None)
    meta = tuple(x.to(META) if torch.is_tensor(x) else x for x in args)
    ops.reset_launch_counts()
    out, lse = fa.FWD_LSE_OP(*args)
    for got, fake in zip((out, lse), fa.FWD_LSE_OP(*meta)):
        _same_layout(fake, got)
    grads = fa.BWD_OP(out, q, k, k, out, pos, pos, lse, True, None)
    for got, fake in zip(grads, fa.BWD_OP(
            *(x.to(META) if torch.is_tensor(x) else x
              for x in (out, q, k, k, out, pos, pos, lse, True, None)))):
        _same_layout(fake, got)
    d = torch.randint(0, 256, (1000,), dtype=torch.int32, device=dev)
    for got, fake in zip(radix_hist.RANK_OP(d), radix_hist.RANK_OP(
            d.to(META))):
        _same_layout(fake, got)
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd"],
            counts["radix_hist"]) == (1, 1, 1)
    from repro_torch import configs

    cfg = _bf16_reduced(configs.ARCHS["phi3-mini-3.8b"])
    flops = {}
    for where in (dev, META):
        model = LM(cfg, device=where, param_dtype=torch.float32)
        if where == dev:
            with torch.no_grad():
                for p in model.parameters():
                    p.normal_(0, 0.02)
        tok = torch.zeros((B, SEQ), dtype=torch.int32, device=where)
        flops[where.type] = analyze_program(
            tts.make_train_step(model, TOptConfig()),
            tts.make_train_state(model), dict(tokens=tok, labels=tok))[
                "flops"]
    assert flops["cuda"] == flops["meta"] > 0


def _bf16_reduced(cfg):
    """The reduced config with bf16 activations and d = 64 heads, which
    the wgmma kernels take."""
    import dataclasses

    return dataclasses.replace(cfg.reduced(), dtype="bfloat16", head_dim=64)
