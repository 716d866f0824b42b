"""The encoder's user surface on IPPP at 192x128, against svt_av1_tpu on
the CPU: per-frame QP overrides (push_qp), scene-change keyframes,
look-ahead q offsets, checkpoint / restore into a fresh encoder, and the
C-API wrappers.  TUs must equal the reference encoder's byte for byte,
with equal recon."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import (assert_same_tus, cut_clip, drive,  # noqa: E402
                           encode_both)
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline import encoder as JE  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline import encoder as TE  # noqa: E402

W, H = 192, 128
IPPP = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=0,
            recon_output=True)


def frames(n, seed=60):
    return [synthetic_frame(W, H, seed=seed + i) for i in range(n)]


def test_port_frame_qindex_consumes_the_queue():
    enc = TE.Encoder(EncoderConfig(width=64, height=64, qp=50),
                     device="cpu")
    enc.push_qp(20)
    enc.push_qp(None)
    assert enc._frame_qindex(True) == 80     # 20 * 4
    assert enc._frame_qindex(True) == 200    # falls back to cfg qp 50
    assert enc._frame_qindex(False) == 200   # empty queue


def test_push_qp_ippp_byte_identical():
    qps = [30, None, 45, 20, 63]
    tus = encode_both(IPPP, frames(5), qps)
    assert [p.qindex for p in tus] == [120, 160, 180, 80, 252]


def test_scene_cut_ippp_keyframe_where_the_reference_puts_one():
    tus = encode_both(IPPP, cut_clip(W, H, 3, 3))
    assert [i for i, p in enumerate(tus) if p.is_keyframe] == [0, 3]


def test_lookahead_ippp_byte_identical():
    tus = encode_both({**IPPP, "look_ahead_distance": 3}, frames(6))
    assert len(tus) == 6
    # the window moved some P frame's qindex off the configured 160
    assert any(p.qindex != 160 for p in tus[1:])


def test_checkpoint_restore_into_a_fresh_encoder():
    """Encode 3 frames, checkpoint, restore into a fresh encoder and
    encode the rest (a mid-GOP resume: the resume frame is a keyframe),
    in both packages; the checkpoints and the TUs are equal."""
    kw = {**IPPP, "intra_period": 3}
    clip = frames(7)

    def resumed(Enc, Cfg, **dev):
        first = Enc(Cfg(**kw), **dev)
        tus = drive(first, clip[:3])
        st = first.checkpoint()
        second = Enc(Cfg(**kw), **dev)
        second.restore(st)
        return st, tus + drive(second, clip[3:])

    st_j, want = resumed(JE.Encoder, JConfig)
    st_t, got = resumed(TE.Encoder, EncoderConfig, device="cpu")
    assert st_t == st_j
    assert_same_tus(want, got)
    assert [i for i, p in enumerate(got) if p.is_keyframe] == [0, 3, 4]


def test_checkpoint_refuses_undrained_packets():
    enc = TE.Encoder(EncoderConfig(**IPPP), device="cpu")
    enc.send_picture(frames(1)[0])
    with pytest.raises(RuntimeError, match="drain"):
        enc.checkpoint()


def test_eb_wrappers_match_the_reference():
    """eb_init_handle / set_parameter / send_picture / get_recon /
    get_packet drive both packages to the same TUs; set_parameter
    replaces the handle's configuration."""
    clip = frames(3)
    out = {}
    for mod, Cfg, dev in ((JE, JConfig, {}),
                          (TE, EncoderConfig, {"device": "cpu"})):
        h = mod.eb_init_handle(Cfg(**IPPP), **dev)
        mod.eb_svt_enc_set_parameter(h, qp=36)
        assert h.cfg.qp == 36
        tus = []
        for f in clip:
            mod.eb_svt_enc_send_picture(h, f)
            rec = mod.eb_svt_get_recon(h)
            pkt = mod.eb_svt_get_packet(h)
            assert rec is pkt.recon
            tus.append(pkt)
        assert mod.eb_svt_get_packet(h) is None
        out[mod] = tus
    assert_same_tus(out[JE], out[TE])
