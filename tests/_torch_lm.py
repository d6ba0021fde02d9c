"""Helpers of the port's LM tests (`tests/test_torch_{lm,mla,ssm,families}.py`):
the JAX package's LM stack, reduced models with the reference's weights,
numpy inputs from a seed, and the serving loop that keeps its logits.

Tolerances, each with its reason:
  * layer functions: atol = rtol = 1e-5 (float32, the same arithmetic;
    only the order of a sum of up to 48 products, or a transcendental's
    last ulp, differs);
  * attention and model logits: atol = rtol = 1e-4 (float32 sums of
    64-128 products per matmul over two layers, in another order);
  * prefill + decode against the full forward: 5e-5, the reference's own
    bound (tests/test_serve.py).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.serve import serve_step as tserve

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
SERVE_TOL = 5e-5


def reference_lm():
    """The JAX package's LM stack (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.models import attention, layers, model, ssm
    from repro.serve import serve_step

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 attention=attention, layers=layers,
                                 model=model, ssm=ssm, serve_step=serve_step)


def reference_fixture():
    """A module fixture's body: the reference, with JAX's compile caches
    cleared before and after the module (each compile maps memory until
    they are cleared)."""
    ref = reference_lm()
    ref.jax.clear_caches()
    yield ref
    ref.jax.clear_caches()


def np32(x):
    return np.asarray(x, dtype=np.float32)


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(np32(got.detach().cpu()) if torch.is_tensor(got)
                               else np32(got), np32(want), atol=tol, rtol=tol,
                               err_msg=msg)


def ref_model(J, name, seed=1, **changes):
    """The reference's reduced `name` (with `changes`), its LM and its
    params as numpy arrays."""
    cfg = dataclasses.replace(J.configs.ARCHS[name].reduced(), **changes)
    m = J.model.LM(cfg)
    params, _ = m.init(J.jax.random.PRNGKey(seed))
    return cfg, m, J.jax.tree.map(np.asarray, params)


def port_cfg(cfg):
    """The port's config with the reference config's fields."""
    return tconfigs.ArchConfig(**dataclasses.asdict(cfg))


def tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def ref_full_logits(J, m, params, toks):
    """The reference's full-sequence logits (its `_run_layers_train`)."""
    x, positions = m._embed_inputs(params, {"tokens": toks})
    x, _ = m._run_layers_train(params, x, positions)
    x = J.layers.rmsnorm(x, params["final_norm"], m.cfg.norm_eps)
    return J.layers.lm_logits(params, x, m.cfg.tie_embeddings)


@torch.inference_mode()
def step_logits(model, prompt, max_new, max_len):
    """`generate`'s loop through the serving steps, keeping the logits:
    the (B, max_new) greedy tokens and the (B, max_new, V) logits that
    chose them (the prefill's last position, then each decode step)."""
    prefill = tserve.make_prefill_step(model)
    decode = tserve.make_decode_step(model)
    s = prompt.shape[1]
    logits, caches = prefill(prompt, model.init_caches(prompt.shape[0],
                                                       max_len))
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    toks, all_logits = [tok], [logits]
    for i in range(max_new - 1):
        tok, logits, caches = decode(tok, s + i, caches)
        toks.append(tok)
        all_logits.append(logits)
    return torch.cat(toks, dim=1), torch.stack(all_logits, dim=1)
