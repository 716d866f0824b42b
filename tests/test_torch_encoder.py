"""Whole-slice parity: the port's Encoder against svt_av1_tpu's on a
3-frame low-delay-P (IPPP) stream at 192x128, and the P step started
from the same reference state in both packages.

Packets must be byte-identical, and the reference package's mirror
decoder must reproduce the port's recon bit-exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.decoder import Decoder  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline import analysis as JAN  # noqa: E402
from svt_av1_tpu.pipeline import inter_encoder as JPE  # noqa: E402
from svt_av1_tpu.pipeline import intra_encoder as JIE  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig as PortConfig  # noqa: E402
from svt_av1_tpu_torch import state  # noqa: E402
from svt_av1_tpu_torch.pipeline import inter_encoder as TPE  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402

W, H = 192, 128
KW = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=0,
          scene_change_detection=False, recon_output=True)


@pytest.fixture(scope="module")
def reference_run():
    """JAX encode of 3 frames; the reference planes after each frame."""
    frames = [synthetic_frame(W, H, seed=i) for i in range(3)]
    cfg = JConfig(**KW)
    enc = JEncoder(cfg)
    pkts, refs = [], []
    for f in frames:
        enc.send_picture(f)
        pkts.append(enc.get_packet())
        refs.append(tuple(np.asarray(p) for p in enc._ref_dev))
    return cfg, frames, pkts, refs, enc._interp_filt


def test_config_from_reference_roundtrip(reference_run):
    cfg = reference_run[0]
    port = state.config_from_reference(dataclasses.asdict(cfg))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    with pytest.raises(ValueError):
        state.config_from_reference({"width": 64, "no_such_field": 1})


def test_p_frame_step_parity_from_reference_state(reference_run):
    """Start both P steps from the reference's keyframe planes."""
    cfg, frames, _pkts, refs, filt = reference_run
    mi_rows, mi_cols = cfg.mi_rows, cfg.mi_cols
    ph, pw = mi_rows * 4, mi_cols * 4
    ph64, pw64 = -(-ph // 64) * 64, -(-pw // 64) * 64
    f = frames[1]
    src = (JIE.pad_plane(f.y, ph64, pw64),
           JIE.pad_plane(f.u, ph64 // 2, pw64 // 2),
           JIE.pad_plane(f.v, ph64 // 2, pw64 // 2))
    gmv = JAN.estimate_global_translation(frames[0].y, f.y,
                                          max_fullpel=JPE.SEARCH_RANGE - 1)
    qindex = 160
    from svt_av1_tpu.ops import deblock as JDB
    ly, lu, lv = JDB.pick_filter_levels(qindex, is_key=False)
    # the same build_p_frame_encoder_dyn call the reference Encoder makes
    # (so both share one jit compile)
    jfn = JPE.build_p_frame_encoder_dyn(
        ph64, pw64, mi_rows, mi_cols, cdef=True, bd=8, rdo=False,
        txs=False, filt=filt, gm=True, lr=False, rect=False)
    want = jfn(*(jnp.asarray(a) for a in src),
               *(jnp.asarray(r) for r in refs[0]), jnp.int32(qindex),
               jnp.int32(ly), jnp.int32(lu), jnp.int32(lv),
               jnp.asarray(np.asarray(gmv or (0, 0), np.int32)))
    tfn = TPE.build_p_frame_encoder_dyn(ph64, pw64, mi_rows, mi_cols,
                                        cdef=True, filt=filt, gm=True)
    got = tfn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in src),
              *state.refs_from_numpy(*refs[0], device="cpu"), qindex, ly,
              lu, lv, gmv or (0, 0))
    lay = JPE.inter_layout(1, False, False, lv8=True, lr=False)
    names = ("sizes", "mv", "ly", "lu", "lv", "rec_y", "rec_u", "rec_v",
             "cdef")
    assert len(got) == len(names)
    for i, n in enumerate(names):
        a = np.asarray(want[lay[n]])
        b = got[i].numpy()
        assert a.shape == b.shape, n
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), n


def test_ippp_packets_byte_identical(reference_run):
    _cfg, frames, want, _refs, _filt = reference_run
    got = list(Encoder(state.config_from_reference(
        dataclasses.asdict(reference_run[0])), device="cpu")
        .encode_all(frames))
    assert len(got) == len(want) == 3
    assert got[0].is_keyframe and not got[1].is_keyframe
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.payload == b.payload, f"frame {i}"
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(a.recon, p), getattr(b.recon, p))
    dec = Decoder()
    for b in got:
        d = dec.decode_temporal_unit(b.payload)
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(d, p), getattr(b.recon, p))


def test_python_entropy_writer_gives_same_bytes(reference_run):
    """The C++ coder and the copied Python TileWriter agree."""
    _cfg, frames, want, _refs, _filt = reference_run
    cfg = PortConfig(**KW, entropy_backend="python")
    got = list(Encoder(cfg, device="cpu").encode_all(frames[:2]))
    assert [g.payload for g in got] == [w.payload for w in want[:2]]
