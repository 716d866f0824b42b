"""The port's all-intra path (every frame a keyframe through the
wavefront + deblock + CDEF) against svt_av1_tpu's: packets
byte-identical."""

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402


@pytest.mark.parametrize("deblock,cdef", [(True, True), (False, False)])
def test_all_intra_byte_identical(deblock, cdef):
    kw = dict(width=72, height=64, qp=32, enable_deblocking=deblock,
              enable_cdef=cdef, recon_output=True)
    frames = [synthetic_frame(72, 64, seed=i) for i in range(2)]
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    assert len(got) == 2 and all(p.is_keyframe for p in got)
    assert [p.payload for p in got] == [p.payload for p in want]
    assert [p.pts for p in got] == [0, 1]
    for a, b in zip(want, got):
        assert (a.recon.y == b.recon.y).all()
