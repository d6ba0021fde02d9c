"""Data pipeline: deterministic synthetic LM streams and binary-file
shards. The port of `repro.data.pipeline`.

Batch `step` is a pure function of (seed, step, process): the host draws
are the reference's numpy draws from `default_rng((seed, step, proc))`,
so a batch equals the reference's bit for bit, and a restarted job
regenerates its data from the checkpointed step with no data state. The
port runs one process (proc 0 of 1); the batch becomes tensors on the
pipeline's device (the card unless the caller asks for another).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.sparsify import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"   # synthetic | file
    path: Optional[str] = None
    is_encoder: bool = False
    feat_dim: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.proc = 0   # one process: the whole global batch
        self.local_batch = cfg.global_batch
        if cfg.kind == "file":
            self._data = np.memmap(cfg.path, dtype=np.uint16, mode="r")

    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, step, self.proc))  # pure function of (seed, step, shard)
        if c.is_encoder:
            feats = rng.standard_normal(
                (self.local_batch, c.seq_len, c.feat_dim)).astype(np.float32)
            labels = rng.integers(0, c.vocab_size,
                                  (self.local_batch, c.seq_len),
                                  dtype=np.int64).astype(np.int32)
            mask = rng.random((self.local_batch, c.seq_len)) < 0.5
            return dict(features=feats, labels=labels, mask=mask)
        if c.kind == "file":
            n = len(self._data) - c.seq_len - 1
            starts = rng.integers(0, n, self.local_batch)
            toks = np.stack([self._data[s: s + c.seq_len + 1]
                             for s in starts]).astype(np.int32)
        else:
            # Markov-ish synthetic stream: learnable but non-trivial
            toks = rng.integers(0, c.vocab_size,
                                (self.local_batch, c.seq_len + 1),
                                dtype=np.int64)
            toks = ((toks + np.cumsum(toks % 7, axis=1)) %
                    c.vocab_size).astype(np.int32)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:])

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch `step` as tensors on the pipeline's device."""
        return {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device)
                for k, v in self._host_batch(step).items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
