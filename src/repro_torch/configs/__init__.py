"""Config registry of the port: --arch <id> resolution (the JAX package's
ten architectures)."""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, cell_skip_reason

from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.granite_moe_3b import CONFIG as _granite

ARCHS = {c.name: c for c in [
    _mamba2, _chameleon, _hymba, _starcoder2, _phi3,
    _minicpm3, _internlm2, _hubert, _dbrx, _granite,
]}

def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_arch",
           "cell_skip_reason"]
