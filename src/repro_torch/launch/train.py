"""Training launcher of the port: the fault-tolerant Trainer.

    python -m repro_torch.launch.train --arch phi3-mini-3.8b --reduced \
        --device cpu --steps 50 --batch 8 --seq 64
    python -m repro_torch.launch.train --arch phi3-mini-3.8b --steps 20 \
        --batch 4 --seq 2048 --layers 16

The twin of `repro.launch.train`: a model of `--arch` (`--reduced` for the
test-sized config; `--layers` cuts the depth) with float32 leaves drawn
from `--seed`, deterministic synthetic data, AdamW with warmup and
cosine decay, checkpoints every `--ckpt-every` steps into `--ckpt-dir`
(a new directory under the temp dir by default) and restarts from the
latest after a failed step. Runs on the CUDA device unless `--device cpu`
is given, and raises without a card otherwise.
"""
import argparse
import dataclasses
import logging
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--compress", choices=["topk", "int8"], default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.sparsify import resolve_device
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.ft.elastic import FaultConfig
    from repro_torch.models.model import LM
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = LM(cfg, device=dev, param_dtype=torch.float32)
    data = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        is_encoder=cfg.is_encoder, feat_dim=cfg.feat_dim), device=dev)
    trainer = Trainer(
        model, data,
        OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                  total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                      micro_batches=args.micro, compress=args.compress,
                      seed=args.seed),
        args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_"),
        fault_cfg=FaultConfig(ckpt_every=args.ckpt_every),
    )
    out = trainer.run()
    h = out["history"]
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"{cfg.name} on {name}: trained {len(h)} steps; loss "
          f"{h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; "
          f"restarts={out['restarts']} stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
