"""Shared checks of the port's parity tests: two TU streams are equal
byte for byte in decode order, with the same timing fields and equal
recon on every coded TU; one hier-B config encoded at 192x128 by both
packages gives such streams; the same frames (and push_qp overrides)
driven through both encoders as the CLI drives them give such streams;
the mirror decoder reproduces the port's recon; and a clip with a hard
scene cut."""

import numpy as np

W, H = 192, 128
HIERB = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=2,
             hierarchical_levels=2, compound_mode=1,
             scene_change_detection=False, recon_output=True)


def assert_same_tus(want, got, qindex=False):
    """qindex: also the TUs' qindex (rate control's per-frame pick)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.payload == b.payload, f"TU {i}"
        assert not qindex or a.qindex == b.qindex, f"TU {i} qindex"
        assert (a.pts, a.show, a.display_idx, a.is_keyframe) == \
            (b.pts, b.show, b.display_idx, b.is_keyframe), f"TU {i}"
        assert (a.recon is None) == (b.recon is None), f"TU {i}"
        if a.recon is not None:
            for p in ("y", "u", "v"):
                assert np.array_equal(getattr(a.recon, p),
                                      getattr(b.recon, p)), f"TU {i} {p}"


def check_hierb_config(extra, n, order):
    """Encode n seeded frames under HIERB + extra through svt_av1_tpu's
    Encoder and the port's (on the CPU); the TUs must be equal, and the
    coded frames must come in the display order `order`, with one
    show-existing TU for every coded frame that is not a keyframe."""
    from svt_av1_tpu import EncoderConfig as JConfig
    from svt_av1_tpu.io.yuv import synthetic_frame
    from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    kw = {**HIERB, **extra}
    frames = [synthetic_frame(W, H, seed=60 + i) for i in range(n)]
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    assert_same_tus(want, got)
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == order
    assert len(got) == 2 * n - sum(p.is_keyframe for p in coded)
    return coded


def drive(enc, frames, qps=None):
    """Send frames one at a time (each after its push_qp override when
    qps is given, None past its end), drain packets after every send and
    after the flush; returns the TUs in decode order."""
    out = []
    for i, f in enumerate(frames):
        if qps is not None:
            enc.push_qp(qps[i] if i < len(qps) else None)
        enc.send_picture(f)
        while (p := enc.get_packet()) is not None:
            out.append(p)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        out.append(p)
    return out


def encode_both(kw, frames, qps=None, qindex=False):
    """The same frames (and push_qp overrides) through svt_av1_tpu's
    Encoder and the port's, on the CPU; their TUs (with qindex: and
    their qindex) must be equal.  Returns the port's TUs."""
    from svt_av1_tpu import EncoderConfig as JConfig
    from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    want = drive(JEncoder(JConfig(**kw)), frames, qps)
    got = drive(Encoder(EncoderConfig(**kw), device="cpu"), frames, qps)
    assert_same_tus(want, got, qindex)
    return got


def assert_decodes_to_recon(tus):
    """The reference package's mirror decoder, fed every TU, gives the
    port's recon in display order."""
    from svt_av1_tpu.decoder import Decoder

    dec = Decoder()
    shown = [f for f in (dec.decode_temporal_unit(p.payload) for p in tus)
             if f is not None]
    coded = [p for p in tus if p.recon is not None]
    order = sorted(coded, key=lambda p: (p.pts if p.display_idx is None
                                         else p.display_idx))
    assert len(shown) == len(order)
    for i, (f, p) in enumerate(zip(shown, order)):
        for pl in ("y", "u", "v"):
            assert np.array_equal(getattr(f, pl), getattr(p.recon, pl)), \
                f"display {i} {pl}"


def cut_clip(w, h, n_a, n_b):
    """A drifting picture of seed 1 for n_a frames, then a drifting
    picture of seed 4: a hard cut at frame n_a (its 1/8-scale mean
    absolute difference is several times the drift's)."""
    from svt_av1_tpu.io.yuv import synthetic_frame

    out = []
    for seed, n in ((1, n_a), (4, n_b)):
        base = synthetic_frame(w, h, seed=seed)
        for i in range(n):
            f = synthetic_frame(w, h, seed=seed)
            f.y[:] = np.roll(base.y, (i, 2 * i), (0, 1))
            out.append(f)
    return out


# a 2x2 tile grid at 320x192 (tile_columns_log2 = tile_rows_log2 = 1)
TILED = dict(width=320, height=192, qp=40, intra_period=-1,
             tile_columns_log2=1, tile_rows_log2=1, recon_output=True)


def tiled_frames(n):
    from svt_av1_tpu.io.yuv import synthetic_frame

    return [synthetic_frame(320, 192, seed=20 + i) for i in range(n)]


def check_tiled(extra, n):
    """n frames under TILED + extra through both packages: equal TUs,
    and the mirror decoder reproduces the port's recon."""
    tus = encode_both({**TILED, **extra}, tiled_frames(n))
    assert_decodes_to_recon(tus)
    return tus


def write_yuv(path, w, h, n, seed=70):
    """n seeded synthetic 4:2:0 frames as a raw YUV file."""
    from svt_av1_tpu.io.yuv import synthetic_frame

    with open(path, "wb") as fh:
        for i in range(n):
            f = synthetic_frame(w, h, seed=seed + i)
            for pl in (f.y, f.u, f.v):
                fh.write(pl.tobytes())


def run_both_clis(tmp_path, flags, files=("ivf", "rec", "stat")):
    """Encode tmp_path/in.yuv with svt_av1_tpu.app.enc_app and with the
    port's (--device cpu) under the same flags; each writes an IVF file
    (-b), a recon file (-o) and a stat file (--stat-file).  Both must
    exit 0 and write byte-identical files.  Returns the port's files'
    bytes by name."""
    from svt_av1_tpu.app import enc_app as japp
    from svt_av1_tpu_torch.app import enc_app as tapp

    out = {}
    for name, app, extra in (("jax", japp, []),
                             ("port", tapp, ["--device", "cpu"])):
        paths = {k: tmp_path / f"{name}.{k}" for k in files}
        argv = ["-i", str(tmp_path / "in.yuv"), *flags, *extra]
        opt = {"ivf": "-b", "rec": "-o", "stat": "--stat-file"}
        for k, p in paths.items():
            argv += [opt[k], str(p)]
        assert app.main(argv) == 0, name
        out[name] = {k: p.read_bytes() for k, p in paths.items()}
    for k in files:
        assert out["port"][k] == out["jax"][k], k
    return out["port"]


def band_clip(w, h, n, axis=1):
    """tests/test_rect.py's clip: two bands moving differently, their
    boundary off the 16/32 node grid, so rect leaves pay (axis 1: the
    top band slides right; axis 0: the left band slides down)."""
    from svt_av1_tpu.io.yuv import synthetic_frame

    base = synthetic_frame(w, h, seed=3)
    hcut, wcut = h // 2 + 8, w // 2 + 24
    frames = []
    for i in range(n):
        f = synthetic_frame(w, h, seed=3)
        if axis == 1:
            f.y[:hcut] = np.roll(base.y[:hcut], 3 * i, 1)
            f.y[hcut:] = base.y[hcut:]
        else:
            f.y[:, :wcut] = np.roll(base.y[:, :wcut], 3 * i, 0)
            f.y[:, wcut:] = base.y[:, wcut:]
        f.u[:] = base.u
        f.v[:] = base.v
        frames.append(f)
    return frames
