"""Multi-stream batching at the RD presets: the reference package's
batched P step runs the float32 RD merge under ``jax.vmap``, and the
port's batched step must write its bytes.  Two lockstep IPPP streams at
preset 7, at 128x96 (merge maps 4 and 2 wide at the 32 and 64 levels:
the power-of-two widths whose 2x2 sum order differs, pipeline/rdo.py),
against svt_av1_tpu's MultiStreamEncoder; the reference decoder must
reproduce the port's recon."""

import numpy as np

from svt_av1_tpu import EncoderConfig as JConfig
from svt_av1_tpu.io import synthetic_frame
from svt_av1_tpu.pipeline.multistream import (
    MultiStreamEncoder as JMultiStream)
from svt_av1_tpu_torch import EncoderConfig
from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder

from _torch_parity import assert_decodes_to_recon, assert_same_tus
from _torch_threads import one_torch_thread  # noqa: F401

W, H, S, N = 128, 96, 2, 3
KW = dict(width=W, height=H, qp=40, intra_period=63, pred_structure=0,
          scene_change_detection=False, recon_output=True, enc_mode=7)


def test_multistream_preset7_equals_reference():
    bases = [synthetic_frame(W, H, seed=40 + s) for s in range(S)]
    slots = []
    for i in range(N):
        fr = []
        for s in range(S):
            f = synthetic_frame(W, H, seed=40 + s)
            f.y[:] = np.roll(bases[s].y, (2 * i, 3 * i + s), (0, 1))
            fr.append(f)
        slots.append(fr)
    ref = JMultiStream(JConfig(**KW), S)
    want = [ref.send(fr) for fr in slots]
    ms = MultiStreamEncoder(EncoderConfig(**KW), S, device="cpu")
    got = [ms.send(fr) for fr in slots]
    for i in range(N):
        assert_same_tus(want[i], got[i])
    for s in range(S):
        assert_decodes_to_recon([slot[s] for slot in got])
