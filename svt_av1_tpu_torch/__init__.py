"""svt_av1_tpu_torch — the PyTorch/CUDA port of svt_av1_tpu.

The JAX package ``svt_av1_tpu`` is the reference; this package encodes
the same streams with PyTorch on an NVIDIA GPU (or on the CPU when the
caller asks for it), and runs the reference's Pallas tile gather as a
hand-written CUDA kernel (``csrc/gather_tiles.cu``).  It imports
neither JAX nor the reference package.

Package map (each module names its counterpart in svt_av1_tpu):
  config      EncoderConfig copy + the port's slice gates
  tables/     normative AV1 constant tables (copy)
  io/, utils/ Y4M/YUV/IVF I/O, bit writers, native builds
  entropy/    range coder, CDF model, symbol layer, OBUs, C++ coder (copy)
  ops/        transforms, quant, intra, deblock, CDEF, gather, MC, ME
  pipeline/   intra wavefront, P/B-frame step, tile writer, GOP planner,
              look-ahead window, Encoder, MultiStreamEncoder
  parallel/   GopShardedEncoder (GOPs of one stream in lockstep)
  app/        the encoder CLI (python -m svt_av1_tpu_torch.app.enc_app)
  state       carrying reference state over from the JAX encoder
"""

__version__ = "0.1.0"

import torch

from svt_av1_tpu_torch.config import EncoderConfig  # noqa: F401

# the f32 forward transform must sum identically on every device: no
# TF32 anywhere (see ops/transforms.fwd_txfm2d_batch)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
