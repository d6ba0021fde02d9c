"""Serving launcher of the port: batched prefill + greedy decode.

    python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --batch 4 --prompt-len 2048 --max-new 32
    python -m repro_torch.launch.serve --arch phi3-mini-3.8b --reduced \
        --device cpu --batch 2 --prompt-len 16 --max-new 8

`--arch` takes every decoder family the port serves: the dense GQA ones
(phi3-mini-3.8b, starcoder2-15b, internlm2-20b, chameleon-34b), MLA
(minicpm3-4b), the SSM (mamba2-370m) and the hybrid with sliding windows
(hymba-1.5b); MoE and the encoder raise NotImplementedError. Runs on the
CUDA device unless `--device cpu` is given, and raises without a card
otherwise. The weights are drawn from `--seed` on the
device; the prompt from the same seed with numpy.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.sparsify import resolve_device
    from repro_torch.models.model import LM
    from repro_torch.serve.serve_step import generate

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    model = LM(cfg, generator=torch.Generator(dev).manual_seed(args.seed),
               device=dev)
    rng = np.random.default_rng(args.seed)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    out = generate(model, prompt, args.max_new,
                   args.prompt_len + args.max_new + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"{cfg.name} on {name}: generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, prefill included)")
    print("sample:", out[0].cpu().tolist()[:16])
    return out


if __name__ == "__main__":
    main()
