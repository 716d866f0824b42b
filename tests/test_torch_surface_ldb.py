"""The encoder's user surface on low-delay B at 192x128, against
svt_av1_tpu on the CPU: a scene cut restarts GOLDEN with a keyframe
where the reference puts one, and checkpoint / restore behaves as the
reference's does, into a fresh encoder (the resume frame is a keyframe)
and into the same encoder (the reference keeps its LAST and GOLDEN
references there, so the resume frame is a B frame: its restore drops
the IPPP and hier-B references only).  TUs must equal the reference
encoder's byte for byte, with equal recon."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import (  # noqa: E402
    assert_decodes_to_recon, assert_same_tus, cut_clip, drive, encode_both)
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline import encoder as JE  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline import encoder as TE  # noqa: E402

W, H = 192, 128
LDB = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=1,
           recon_output=True)


def test_scene_cut_ldb_keyframe_where_the_reference_puts_one():
    tus = encode_both(LDB, cut_clip(W, H, 3, 3))
    assert [i for i, p in enumerate(tus) if p.is_keyframe] == [0, 3]
    assert_decodes_to_recon(tus)


@pytest.mark.parametrize("fresh,keys", [(True, [0, 3]), (False, [0])],
                         ids=["fresh-encoder", "same-encoder"])
def test_ldb_checkpoint_restore_as_the_reference(fresh, keys):
    clip = [synthetic_frame(W, H, seed=60 + i) for i in range(6)]

    def resumed(Enc, Cfg, **dev):
        first = Enc(Cfg(**LDB), **dev)
        tus = drive(first, clip[:3])
        st = first.checkpoint()
        second = Enc(Cfg(**LDB), **dev) if fresh else first
        second.restore(st)
        return st, tus + drive(second, clip[3:])

    st_j, want = resumed(JE.Encoder, JConfig)
    st_t, got = resumed(TE.Encoder, EncoderConfig, device="cpu")
    assert st_t == st_j
    assert_same_tus(want, got)
    assert [i for i, p in enumerate(got) if p.is_keyframe] == keys
