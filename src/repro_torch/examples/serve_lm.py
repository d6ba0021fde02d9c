"""Serve a small model with batched requests: prefill a batch of prompts,
decode greedily with persistent KV/SSM caches. The twin of
`examples/serve_lm.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

The reduced config of `--arch`, weights drawn from seed 0 (a
`torch.Generator`, so not the reference's `jax.random` bits), prompts from
numpy's `default_rng(0)` as in the reference. Runs on the CUDA device
unless `--device cpu` is given; without a card the default raises.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.sparsify import resolve_device
from repro_torch.models.model import LM
from repro_torch.serve.serve_step import generate


def prompts_for(cfg, batch: int, prompt_len: int) -> np.ndarray:
    """The reference's prompts: default_rng(0) integers below the vocab."""
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(
        np.int32)


def serve(model: LM, prompts: np.ndarray, max_new: int) -> torch.Tensor:
    """`generate` over the prompts with the reference's cache length:
    (B, max_new) int32 tokens on the model's device."""
    prompt_len = prompts.shape[1]
    return generate(model, torch.from_numpy(prompts), max_new,
                    prompt_len + max_new + 1)


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(0),
               device=dev)
    prompts = prompts_for(cfg, args.batch, args.prompt_len)
    t0 = time.perf_counter()
    out = serve(model, prompts, args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} (reduced) batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new}")
    print(f"{args.batch * args.max_new} tokens in {dt:.2f}s "
          f"(incl. compile)")
    for i in range(min(2, args.batch)):
        print(f"  sample {i}: {out[i].cpu().tolist()}")
    return out


if __name__ == "__main__":
    main()
