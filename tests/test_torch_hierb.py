"""Hierarchical-B parity: the port's two-reference step and Encoder
against svt_av1_tpu's at 192x128.

A 12-frame stream at hierarchical_levels=3 with compound prediction
codes one keyframe, one full 8-frame mini-GOP and, at flush, a
truncated 3-frame span; a 6-frame stream at hierarchical_levels=2 codes
a 4-frame mini-GOP and a truncated 1-frame span.  Their TUs must equal
the reference encoder's byte for byte in decode order, and the
reference package's mirror decoder must reproduce the port's recon in
display order.  The B step alone, started from the reference encoder's
slot-book planes, must give the reference step's outputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_same_tus  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.decoder import Decoder  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.ops import deblock as JDB  # noqa: E402
from svt_av1_tpu.pipeline import inter_encoder as JPE  # noqa: E402
from svt_av1_tpu.pipeline import intra_encoder as JIE  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch import state  # noqa: E402
from svt_av1_tpu_torch.pipeline import inter_encoder as TPE  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402

W, H, N = 192, 128, 12
KW = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=2,
          hierarchical_levels=3, compound_mode=1,
          scene_change_detection=False, recon_output=True)


@pytest.fixture(scope="module")
def reference_run():
    """The reference encode, with the first B frame's dispatch recorded:
    (step, source, qindex, the slot book as it stood)."""
    frames = [synthetic_frame(W, H, seed=30 + i) for i in range(N)]
    enc = JEncoder(JConfig(**KW))
    first_b = []
    dispatch = enc._dispatch_code

    def spy(step, frame, qindex, pins, alt=None, stats=None):
        if step.bwd is not None and not first_b:
            book = {d: {"dev": tuple(np.asarray(p) for p in e["dev"]),
                        "slot": e["slot"], "pins": e["pins"]}
                    for d, e in enc._store.items()}
            first_b.append((step, frame, qindex, book))
        return dispatch(step, frame, qindex, pins, alt=alt, stats=stats)

    enc._dispatch_code = spy
    pkts = list(enc.encode_all(frames))
    return frames, pkts, first_b[0], enc._interp_filt


@pytest.fixture(scope="module")
def port_run(reference_run):
    frames = reference_run[0]
    return list(Encoder(EncoderConfig(**KW), device="cpu").encode_all(frames))


def test_b_step_parity_from_reference_slot_book(reference_run):
    _frames, _pkts, (step, f, q, book), filt = reference_run
    cfg = JConfig(**KW)
    mi_rows, mi_cols = cfg.mi_rows, cfg.mi_cols
    ph64 = -(-mi_rows * 4 // 64) * 64
    pw64 = -(-mi_cols * 4 // 64) * 64
    src = (JIE.pad_plane(f.y, ph64, pw64),
           JIE.pad_plane(f.u, ph64 // 2, pw64 // 2),
           JIE.pad_plane(f.v, ph64 // 2, pw64 // 2))
    ly, lu, lv = JDB.pick_filter_levels(q, is_key=False)
    # the same build call the reference Encoder makes (one jit compile)
    jfn = JPE.build_b_frame_encoder_dyn(
        ph64, pw64, mi_rows, mi_cols, cdef=True, compound=True, bd=8,
        rdo=False, txs=False, filt=filt, lr=False, rect=False, nrefs=2,
        aq=False)
    want = jfn(*(jnp.asarray(a) for a in src),
               *book[step.fwd]["dev"], *book[step.bwd]["dev"],
               jnp.int32(q), jnp.int32(ly), jnp.int32(lu), jnp.int32(lv))
    port_book = state.store_from_reference(book, device="cpu")
    assert {d: (e["slot"], e["pins"]) for d, e in port_book.items()} == \
        {d: (e["slot"], e["pins"]) for d, e in book.items()}
    tfn = TPE.build_b_frame_encoder_dyn(ph64, pw64, mi_rows, mi_cols,
                                        cdef=True, compound=True, filt=filt)
    got = tfn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in src),
              *port_book[step.fwd]["dev"], *port_book[step.bwd]["dev"],
              q, ly, lu, lv)
    want_lay = JPE.inter_layout(2, True, False, lv8=True, lr=False)
    names = list(TPE.inter_layout(2, True, False, lv8=False, lr=False))
    assert names[-2:] == ["ref8", "mv2"] and len(got) == len(names)
    for i, n in enumerate(names):
        a = np.asarray(want[want_lay[n]])
        b = got[i].numpy()
        assert a.shape == b.shape, n
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), n
    ref8 = got[names.index("ref8")].numpy()
    assert (ref8 == 2).any() and (ref8 == 1).any() and (ref8 == 0).any()


def test_hierb_tus_byte_identical_in_decode_order(reference_run, port_run):
    want, got = reference_run[1], port_run
    # 12 coded TUs (1 key + 8 + 3) and 11 show-existing TUs
    assert len(got) == len(want) == 2 * N - 1
    assert_same_tus(want, got)
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 8, 4, 2, 1, 3, 6, 5, 7,
                                              11, 9, 10]
    assert all(p.pts == -1 and not p.show for p in coded[1:])
    assert sum(p.compound_cells or 0 for p in coded) > 0


def test_decoder_reproduces_port_recon_in_display_order(port_run):
    dec = Decoder()
    shown, ref_select = [], []
    for p in port_run:
        f = dec.decode_temporal_unit(p.payload)
        if p.recon is not None and not p.is_keyframe:
            ref_select.append(dec.fp.reference_select)
            assert dec.fp.reference_select == bool(p.compound_cells)
        if f is not None:
            shown.append(f)
    assert any(ref_select)
    recon = {p.display_idx: p.recon for p in port_run if p.recon is not None}
    assert len(shown) == len(recon) == N
    for d, f in enumerate(shown):
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(f, p), getattr(recon[d], p)), \
                f"display {d} plane {p}"


def test_hierb_levels2_truncated_byte_identical(reference_run):
    """Same geometry and tools as the stream above (the reference's step
    compiles are shared), smaller mini-GOP."""
    frames = reference_run[0][:6]
    kw = {**KW, "hierarchical_levels": 2}
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    assert len(got) == len(want) == 11
    assert_same_tus(want, got)
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 4, 2, 1, 3, 5]
