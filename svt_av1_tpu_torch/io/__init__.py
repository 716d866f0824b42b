"""Frame I/O: Y4M/YUV readers, IVF writer/reader.

Copy of svt_av1_tpu.io. Reference parity: EbAppInputy4m.c (Y4M), ReadInputFrames
(EbAppProcessCmd.c:759, raw YUV), write_ivf_stream_header /
write_ivf_frame_header (EbAppProcessCmd.c:1076/:1120).
"""

from svt_av1_tpu_torch.io.ivf import IvfReader, IvfWriter  # noqa: F401
from svt_av1_tpu_torch.io.yuv import (Y4MReader, YuvReader, YuvReader10,  # noqa: F401
                                YuvReaderPacked10, synthetic_frame)
