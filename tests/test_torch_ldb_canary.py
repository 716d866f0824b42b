"""Low-delay-B parity at the 854x480 canary (a width that is not a
multiple of 64 and above 512): a keyframe and three LAST + GOLDEN
frames from the port equal svt_av1_tpu's TUs byte for byte, with equal
recon and PSNR, scene-change detection on."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_same_tus, drive  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402


def test_canary_854x480_ldb_byte_identical():
    kw = dict(width=854, height=480, qp=40, intra_period=-1,
              pred_structure=1, recon_output=True, stat_report=True)
    frames = [synthetic_frame(854, 480, seed=50 + i) for i in range(4)]
    want = drive(JEncoder(JConfig(**kw)), frames)
    got = drive(Encoder(EncoderConfig(**kw), device="cpu"), frames)
    assert_same_tus(want, got)
    assert [p.is_keyframe for p in got] == [True, False, False, False]
    for a, b in zip(want, got):
        assert np.allclose(a.psnr, b.psnr)
