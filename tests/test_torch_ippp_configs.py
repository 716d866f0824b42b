"""IPPP parity over every low-delay-P configuration that the port's
check_slice accepts beyond the defaults: periodic keyframes, global
motion off, a fixed sharp interpolation filter, in-loop filters off,
and the ends of the qp range.  Each case encodes at 192x128 through the
port's Encoder on the CPU and through svt_av1_tpu's Encoder, and
asserts byte-identical packets and equal recon."""

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

W, H = 192, 128
BASE = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=0,
            scene_change_detection=False, recon_output=True)
# (id, config overrides, frames): intra_period=5 codes 7 frames so the
# second keyframe (index 6) is coded
CASES = [
    ("intra_period=5", dict(intra_period=5), 7),
    ("global_motion_off", dict(enable_global_motion=False), 3),
    ("interp_filter=2", dict(interp_filter=2), 3),
    ("filters_off", dict(enable_deblocking=False, enable_cdef=False), 3),
    ("qp0", dict(qp=0), 3),
    ("qp63", dict(qp=63), 3),
]


@pytest.mark.parametrize("extra,n", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_ippp_config_byte_identical(extra, n):
    kw = {**BASE, **extra}
    frames = [synthetic_frame(W, H, seed=20 + i) for i in range(n)]
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    assert len(got) == len(want) == n
    keys = [i for i, p in enumerate(got) if p.is_keyframe]
    assert keys == [i for i, p in enumerate(want) if p.is_keyframe]
    assert keys == ([0, 6] if kw["intra_period"] == 5 else [0])
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.payload == b.payload, f"frame {i}"
        assert a.pts == b.pts == i
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(a.recon, p), getattr(b.recon, p)), \
                f"frame {i} plane {p}"
