"""End-to-end driver of the port: train a ~100M-parameter LM with the
fault-tolerant trainer (checkpoint/restart + deterministic data); the
twin of `examples/train_lm.py`.

    python -m repro_torch.examples.train_lm --steps 300
    python -m repro_torch.examples.train_lm --device cpu
(20 steps by default, so the demo finishes quickly; the card unless
`--device cpu` is given)
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.core.sparsify import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.ft.elastic import FaultConfig
from repro_torch.models.model import LM
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # ~100M params: a scaled-down mamba2 (the paper-assigned SSM family)
    cfg = dataclasses.replace(
        get_arch("mamba2-370m"),
        n_layers=16, d_model=768, vocab_size=32000,
        ssm_state=64, ssm_chunk=64, dtype="float32", remat=False)
    model = LM(cfg, device=dev, param_dtype=torch.float32)
    print(f"model: {cfg.n_params()/1e6:.1f}M params on {dev}")

    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                    global_batch=4, seed=0), device=dev)
    trainer = Trainer(
        model, data,
        OptConfig(peak_lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                  total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, log_every=5),
        args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_lm_"),
        fault_cfg=FaultConfig(ckpt_every=50),
    )
    out = trainer.run()
    h = out["history"]
    print(f"loss: {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} over "
          f"{len(h)} steps")
    return out


if __name__ == "__main__":
    main()
