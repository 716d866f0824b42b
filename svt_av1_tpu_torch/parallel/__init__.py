"""GOP-parallel encoding (port of svt_av1_tpu/parallel)."""

from svt_av1_tpu_torch.parallel.gop import GopShardedEncoder

__all__ = ["GopShardedEncoder"]
