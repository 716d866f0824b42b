"""Whole-slice parity at the 854x480 canary (a width that is not a
multiple of 64 and above 512, where header bit-layout bugs show): a
3-frame IPPP stream from the port equals svt_av1_tpu's byte for byte,
with equal recon and PSNR.  (The mirror-decoder check of the port's
recon runs at 192x128 in test_torch_encoder.py; at this size the Python
decoder alone would take most of this file's time budget.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402


def test_canary_854x480_ippp_byte_identical():
    kw = dict(width=854, height=480, qp=40, intra_period=-1,
              pred_structure=0, scene_change_detection=False,
              recon_output=True, stat_report=True)
    frames = [synthetic_frame(854, 480, seed=i) for i in range(3)]
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    assert [p.payload for p in got] == [p.payload for p in want]
    for a, b in zip(want, got):
        assert np.allclose(a.psnr, b.psnr)
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(a.recon, p), getattr(b.recon, p))
    assert 25.0 < got[1].psnr[0] < 50.0
