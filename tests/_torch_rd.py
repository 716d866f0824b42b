"""Shared inputs of the port's RD-preset step tests: a source picture of
the moving synthetic clip and up to three references from other clip
times, each with strong noise over a different third of the picture, so
the per-size reference choice, the compound candidate and the partition
merge all see real alternatives."""

import numpy as np

W, H = 192, 128


def step_planes(nrefs: int, w: int = W, h: int = H, seed: int = 0):
    """(source planes, [3 * nrefs] reference planes), 8-bit, padded to
    the 64-multiple geometry of the inter step."""
    from svt_av1_tpu_torch.io.yuv import synthetic_clip
    from svt_av1_tpu_torch.pipeline.intra_encoder import pad_plane

    clip = synthetic_clip(w, h, 8)
    rng = np.random.default_rng(seed)
    ph, pw = -(-h // 64) * 64, -(-w // 64) * 64

    def pad(f):
        return (pad_plane(f.y, ph, pw), pad_plane(f.u, ph // 2, pw // 2),
                pad_plane(f.v, ph // 2, pw // 2))

    src = pad(clip[3])
    refs = []
    for k, t in enumerate((2, 5, 0)[:nrefs]):
        y, u, v = pad(clip[t])
        amp = np.full(y.shape, 2)
        amp[:, k * pw // 3:(k + 1) * pw // 3] = 24
        y = np.clip(y.astype(np.int32)
                    + rng.integers(-amp, amp + 1), 0, 255).astype(np.uint8)
        refs += [y, u, v]
    return src, refs


def check_step(nrefs: int, compound: bool, filt: int, qs, gm: bool = False,
               w: int = W, h: int = H, ldb: bool = False, p5: bool = False):
    """Run svt_av1_tpu's jitted RD step and the port's on
    step_planes(nrefs) at each qindex of qs; every output must be equal.
    The reference step is built with the keywords its Encoder passes
    (hier-B, IPPP with gm, or low-delay B with ldb; p5: at presets <= 5,
    with the tx-type search and rect leaves), so one compile serves the
    encoder tests of the same file.  Returns the port's outputs of the
    last q by name."""
    import jax.numpy as jnp
    import torch

    from svt_av1_tpu.ops import deblock as JDB
    from svt_av1_tpu.pipeline import inter_encoder as JPE
    from svt_av1_tpu_torch.pipeline import inter_encoder as TPE

    src, refs = step_planes(nrefs, w, h)
    ph, pw = src[0].shape
    mi_rows, mi_cols = 2 * ((h + 7) >> 3), 2 * ((w + 7) >> 3)
    geo = (ph, pw, mi_rows, mi_cols)
    if nrefs == 1 and gm:
        jfn = JPE.build_p_frame_encoder_dyn(
            *geo, cdef=True, bd=8, rdo=True, txs=p5, filt=filt, gm=True,
            lr=False, rect=p5)
    elif nrefs == 1:
        jfn = JPE.build_p_frame_encoder_dyn(
            *geo, cdef=True, bd=8, rdo=True, txs=p5, filt=filt, lr=False,
            rect=p5, aq=False)
    elif ldb:
        jfn = JPE.build_b_frame_encoder_dyn(
            *geo, cdef=True, bd=8, rdo=True, txs=p5, filt=filt, lr=False,
            rect=p5)
    else:
        jfn = JPE.build_b_frame_encoder_dyn(
            *geo, cdef=True, compound=compound, bd=8, rdo=True, txs=p5,
            filt=filt, lr=False, rect=p5, nrefs=nrefs, aq=False)
    if nrefs == 1:
        tfn = TPE.build_p_frame_encoder_dyn(*geo, cdef=True, bd=8, rdo=True,
                                            txs=p5, filt=filt, gm=gm,
                                            rect=p5)
    else:
        tfn = TPE.build_b_frame_encoder_dyn(*geo, cdef=True,
                                            compound=compound, bd=8,
                                            filt=filt, rdo=True, nrefs=nrefs,
                                            txs=p5, rect=p5)
    gmv = (11, -6)          # 1/8 pel: a subpel global translation
    names = TPE.inter_layout(nrefs, compound, p5, False, False, rect=p5)
    for q in qs:
        ly, lu, lv = JDB.pick_filter_levels(q, is_key=False)
        jargs = [jnp.asarray(p) for p in (*src, *refs)]
        jargs += [jnp.int32(q), jnp.int32(ly), jnp.int32(lu), jnp.int32(lv)]
        if gm:
            jargs.append(jnp.asarray(np.array(gmv, np.int32)))
        want = jfn(*jargs)
        targs = [torch.from_numpy(np.ascontiguousarray(p))
                 for p in (*src, *refs)]
        got = tfn(*targs, q, ly, lu, lv, *((gmv,) if gm else ()))
        assert len(got) == len(names)
        for name, i in names.items():
            a = np.asarray(want[i])
            b = got[i].numpy()
            assert a.shape == b.shape, (q, name)
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), \
                (q, name)
    return {name: got[i].numpy() for name, i in names.items()}
