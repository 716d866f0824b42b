"""OBU framing + sequence/frame headers (writer and parser).

Covers the v1 coding configuration: profile 0 (8-bit 4:2:0), intra
keyframes, CQP, single uniform tile grid, in-loop filters signaled off.
Writer and parser are paired in this module so the mirror decoder stays
in lockstep with the encoder.

Reference parity: EncodeSPSAv1 (EbEntropyCoding.c:4303),
WriteFrameHeaderObu (:4214), encode_td_av1 (:4333), OBU header/LEB128
(EbEntropyCoding.h:180-183), packetization (EbPacketizationProcess.c:240).
"""

from __future__ import annotations

from dataclasses import dataclass

from svt_av1_tpu_torch.utils.bits import BitReader, BitWriter, leb128, read_leb128

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_FRAME = 6


def wrap_obu(obu_type: int, payload: bytes) -> bytes:
    hdr = BitWriter()
    hdr.f(0, 1).f(obu_type, 4).f(0, 1).f(1, 1).f(0, 1)  # has_size_field=1
    return hdr.data() + leb128(len(payload)) + payload


def temporal_delimiter() -> bytes:
    return wrap_obu(OBU_TEMPORAL_DELIMITER, b"")


def _seq_level_idx(width: int, height: int) -> int:
    pic = width * height
    if pic <= 2228224 and width <= 2048:   # 4.0
        return 8
    if pic <= 8912896 and width <= 4096:   # 5.0
        return 12
    return 13                              # 5.1


@dataclass
class SequenceParams:
    width: int
    height: int
    bit_depth: int = 8
    sb_size: int = 64
    enable_cdef: bool = False
    # order hints (hier-B / random access; ref EbEncSettings.c
    # enable_order_hint, spec 5.5.1).  jnt_comp and ref_frame_mvs stay
    # off (no temporal MV prediction in this build).
    enable_order_hint: bool = False
    order_hint_bits: int = 8
    film_grain_present: bool = False
    enable_restoration: bool = False
    enable_warped_motion: bool = False
    # screen content: seq_choose_screen_content_tools=1 (SELECT) so each
    # frame codes allow_screen_content_tools; integer-mv also SELECT
    screen_content: bool = False

    @property
    def mi_cols(self) -> int:
        return 2 * ((self.width + 7) >> 3)

    @property
    def mi_rows(self) -> int:
        return 2 * ((self.height + 7) >> 3)


def write_sequence_header(sp: SequenceParams) -> bytes:
    w = BitWriter()
    w.f(0, 3)      # seq_profile
    w.f(0, 1)      # still_picture
    w.f(0, 1)      # reduced_still_picture_header
    w.f(0, 1)      # timing_info_present_flag
    w.f(0, 1)      # initial_display_delay_present_flag
    w.f(0, 5)      # operating_points_cnt_minus_1
    w.f(0, 12)     # operating_point_idc[0]
    lvl = _seq_level_idx(sp.width, sp.height)
    w.f(lvl, 5)    # seq_level_idx[0]
    if lvl > 7:
        w.f(0, 1)  # seq_tier[0]
    wbits = max(1, (sp.width - 1).bit_length())
    hbits = max(1, (sp.height - 1).bit_length())
    w.f(wbits - 1, 4).f(hbits - 1, 4)
    w.f(sp.width - 1, wbits).f(sp.height - 1, hbits)
    w.f(0, 1)      # frame_id_numbers_present_flag
    w.f(0, 1)      # use_128x128_superblock
    w.f(0, 1)      # enable_filter_intra
    w.f(0, 1)      # enable_intra_edge_filter
    w.f(0, 1)      # enable_interintra_compound
    w.f(0, 1)      # enable_masked_compound
    w.f(int(sp.enable_warped_motion), 1)
    w.f(0, 1)      # enable_dual_filter
    w.f(int(sp.enable_order_hint), 1)
    if sp.enable_order_hint:
        w.f(0, 1)  # enable_jnt_comp
        w.f(0, 1)  # enable_ref_frame_mvs
    if sp.screen_content:
        w.f(1, 1)  # seq_choose_screen_content_tools -> SELECT(2)
        w.f(1, 1)  # seq_choose_integer_mv -> SELECT(2)
    else:
        w.f(0, 1)  # seq_choose_screen_content_tools
        w.f(0, 1)  # seq_force_screen_content_tools = OFF
    if sp.enable_order_hint:
        w.f(sp.order_hint_bits - 1, 3)  # order_hint_bits_minus_1
    w.f(0, 1)      # enable_superres
    w.f(int(sp.enable_cdef), 1)
    w.f(int(sp.enable_restoration), 1)
    # color_config
    w.f(int(sp.bit_depth == 10), 1)   # high_bitdepth
    w.f(0, 1)      # mono_chrome
    w.f(0, 1)      # color_description_present_flag
    w.f(0, 1)      # color_range
    w.f(0, 2)      # chroma_sample_position
    w.f(0, 1)      # separate_uv_delta_q
    w.f(int(sp.film_grain_present), 1)
    w.trailing_bits()
    return wrap_obu(OBU_SEQUENCE_HEADER, w.data())


def parse_sequence_header(payload: bytes) -> SequenceParams:
    r = BitReader(payload)
    assert r.f(3) == 0, "profile"
    r.f(1)
    assert r.f(1) == 0, "reduced header unsupported"
    assert r.f(1) == 0 and r.f(1) == 0
    assert r.f(5) == 0
    r.f(12)
    lvl = r.f(5)
    if lvl > 7:
        r.f(1)
    wbits = r.f(4) + 1
    hbits = r.f(4) + 1
    width = r.f(wbits) + 1
    height = r.f(hbits) + 1
    # frame_id_numbers, use_128x128_superblock, enable_filter_intra,
    # enable_intra_edge_filter, enable_interintra_compound,
    # enable_masked_compound, enable_warped_motion, enable_dual_filter
    flags = [r.f(1) for _ in range(8)]
    enable_warped = bool(flags[6])
    flags[6] = 0
    assert not any(flags), f"unsupported seq flags {flags}"
    enable_order_hint = bool(r.f(1))
    order_hint_bits = 8
    if enable_order_hint:
        assert r.f(1) == 0  # enable_jnt_comp
        assert r.f(1) == 0  # enable_ref_frame_mvs
    screen_content = bool(r.f(1))   # seq_choose_screen_content_tools
    if screen_content:
        assert r.f(1) == 1          # seq_choose_integer_mv = SELECT
    else:
        assert r.f(1) == 0          # seq_force_screen_content_tools
    if enable_order_hint:
        order_hint_bits = r.f(3) + 1
    assert r.f(1) == 0  # enable_superres
    enable_cdef = bool(r.f(1))
    enable_restoration = bool(r.f(1))
    bit_depth = 10 if r.f(1) else 8   # high_bitdepth
    assert r.f(1) == 0  # mono
    assert r.f(1) == 0  # color desc
    r.f(1)              # color_range
    r.f(2)              # chroma_sample_position
    assert r.f(1) == 0  # separate_uv_delta_q
    film_grain = bool(r.f(1))
    return SequenceParams(width, height, bit_depth,
                          enable_cdef=enable_cdef,
                          enable_order_hint=enable_order_hint,
                          order_hint_bits=order_hint_bits,
                          film_grain_present=film_grain,
                          enable_restoration=enable_restoration,
                          enable_warped_motion=enable_warped,
                          screen_content=screen_content)


KEY_FRAME, INTER_FRAME = 0, 1
PRIMARY_REF_NONE = 7


def get_relative_dist(sp: SequenceParams, a: int, b: int) -> int:
    """Signed wrap-around order-hint distance (spec get_relative_dist;
    ref av1_get_relative_dist)."""
    if not sp.enable_order_hint:
        return 0
    diff = a - b
    m = 1 << (sp.order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def ref_sign_biases(sp: SequenceParams, order_hint: int,
                    ref_order_hints) -> tuple:
    """RefFrameSignBias per ref type 1..7 (index 0 unused): 1 when the
    reference is backward (its order hint is after the current frame's).
    Shared by the tile writer and the mirror decoder so MV sign flips in
    the ref-MV stack cannot diverge (spec 5.9.2 ref_frame_sign_bias)."""
    out = [0] * 8
    for i in range(7):
        out[i + 1] = int(get_relative_dist(sp, ref_order_hints[i],
                                           order_hint) > 0)
    return tuple(out)


def skip_mode_allowed(sp: SequenceParams, order_hint: int,
                      ref_order_hints) -> bool:
    """spec 5.9.22 skip_mode_params gate: needs one forward + one
    backward ref (or two distinct forward refs) by order hint.
    ref_order_hints[i] is RefOrderHint[ref_frame_idx[i]], i = 0..6."""
    if not sp.enable_order_hint:
        return False
    fwd_i, fwd_h, bwd_i, bwd_h = -1, 0, -1, 0
    for i in range(7):
        h = ref_order_hints[i]
        d = get_relative_dist(sp, h, order_hint)
        if d < 0:
            if fwd_i < 0 or get_relative_dist(sp, h, fwd_h) > 0:
                fwd_i, fwd_h = i, h
        elif d > 0:
            if bwd_i < 0 or get_relative_dist(sp, h, bwd_h) < 0:
                bwd_i, bwd_h = i, h
    if fwd_i < 0:
        return False
    if bwd_i >= 0:
        return True
    snd_i, snd_h = -1, 0
    for i in range(7):
        h = ref_order_hints[i]
        if (get_relative_dist(sp, h, fwd_h) < 0
                and (snd_i < 0 or get_relative_dist(sp, h, snd_h) > 0)):
            snd_i, snd_h = i, h
    return snd_i >= 0


@dataclass
class FrameParams:
    base_q_idx: int
    disable_cdf_update: bool = False
    reduced_tx_set: bool = True
    tx_mode_select: int = 0         # 0 = TX_MODE_LARGEST
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    frame_type: int = KEY_FRAME
    refresh_frame_flags: int = 0xFF   # inter frames refresh slot0 only
    ref_frame_idx: tuple = (0,) * 7   # all LAST..ALTREF -> slot 0
    show_frame: bool = True           # 0: stored only, shown later via
    #                                   show_existing_frame (hier-B)
    order_hint: int = 0               # coded when seq enable_order_hint
    # RefOrderHint[ref_frame_idx[i]] for i=0..6 — drives the skip-mode
    # header gate (spec 5.9.22); filled by the scheduler for hier-B
    ref_order_hints: tuple = (0,) * 7
    reference_select: bool = False    # compound blocks allowed
    # loop filter levels (y-vert, y-horz, u, v); 0 = off
    filter_levels: tuple = (0, 0, 0, 0)
    # cdef (present in headers only when the sequence enables cdef)
    cdef_damping: int = 3
    cdef_bits: int = 2
    cdef_y_strengths: tuple = ((0, 0),) * 4     # (pri, sec-coded) pairs
    cdef_uv_strengths: tuple = ((0, 0),) * 4
    film_grain: object = None         # FilmGrainParams when seq enables
    # loop restoration (spec 5.9.20): coded per-plane type
    # (0 NONE, 1 SWITCHABLE, 2 WIENER, 3 SGRPROJ) + unit size shifts
    lr_types: tuple = (0, 0, 0)
    lr_unit_shift: int = 0            # luma RU = 64 << shift (sb 64)
    lr_uv_shift: int = 0
    # frame-level interpolation_filter (spec 5.9.10 read_interpolation_
    # filter; ref EbDefinitions.h InterpFilter): 0 EIGHTTAP_REGULAR,
    # 1 EIGHTTAP_SMOOTH, 2 EIGHTTAP_SHARP; is_filter_switchable stays 0
    interp_filter: int = 0
    # global motion (spec 5.9.24 global_motion_params; ref
    # WriteGlobalMotion, EbEntropyCoding.c:3532): per LAST..ALTREF type
    # (0 IDENTITY, 1 TRANSLATION) and the translation in 1/8-pel units
    # (even values -- allow_high_precision_mv=0), (row, col) like MVs
    gm_types: tuple = (0,) * 7
    gm_trans: tuple = ((0, 0),) * 7
    # warped motion (spec is_motion_mode_switchable + allow_warped_
    # motion; params are decoder-derived per block, never coded)
    switchable_motion_mode: bool = False
    allow_warped_motion: bool = False
    # screen content (spec 5.9.2: allow_screen_content_tools coded when
    # seq_force == SELECT; allow_intrabc coded on intra frames — when
    # set, the loop filter / cdef / lr params are NOT coded and the
    # in-loop filters are off, spec 5.9.11/5.9.19/5.9.20)
    allow_screen_content: bool = False
    allow_intrabc: bool = False
    # per-superblock delta-q (spec 5.9.17 quantization_params):
    # delta_q_present gates the per-SB syntax; delta_q_res (0..3) is the
    # log2 step (per-SB deltas apply as reduced << delta_q_res).  A
    # conformant stream may code present=1 with res=0, so the two are
    # tracked separately; delta_q_res > 0 with present unset still means
    # "on" (the encoder's historical shorthand).
    delta_q_res: int = 0
    delta_q_present: bool = False

    @property
    def delta_q_on(self) -> bool:
        return self.delta_q_present or self.delta_q_res > 0

    @property
    def is_intra(self) -> bool:
        return self.frame_type == KEY_FRAME


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def _tile_info_bits(w: BitWriter, sp: SequenceParams, fp: FrameParams) -> None:
    """spec tile_info(), uniform spacing only."""
    sb_cols = (sp.mi_cols + 15) >> 4
    sb_rows = (sp.mi_rows + 15) >> 4
    max_tile_width_sb = 4096 >> 6
    max_tile_area_sb = (4096 * 2304) >> 12
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    w.f(1, 1)  # uniform_tile_spacing_flag
    assert fp.tile_cols_log2 >= min_log2_tile_cols
    k = min_log2_tile_cols
    while k < max_log2_tile_cols:
        if k < fp.tile_cols_log2:
            w.f(1, 1)
            k += 1
        else:
            w.f(0, 1)
            break
    min_log2_tile_rows = max(min_log2_tiles - fp.tile_cols_log2, 0)
    assert fp.tile_rows_log2 >= min_log2_tile_rows
    k = min_log2_tile_rows
    while k < max_log2_tile_rows:
        if k < fp.tile_rows_log2:
            w.f(1, 1)
            k += 1
        else:
            w.f(0, 1)
            break
    if fp.tile_cols_log2 or fp.tile_rows_log2:
        w.f(0, fp.tile_cols_log2 + fp.tile_rows_log2)  # context_update_tile_id
        w.f(3, 2)  # tile_size_bytes_minus_1 = 3 (4-byte tile sizes)


def _parse_tile_info(r: BitReader, sp: SequenceParams) -> tuple[int, int]:
    sb_cols = (sp.mi_cols + 15) >> 4
    sb_rows = (sp.mi_rows + 15) >> 4
    min_log2_tile_cols = _tile_log2(64, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2((4096 * 2304) >> 12, sb_rows * sb_cols))
    assert r.f(1) == 1, "only uniform tile spacing supported"
    cols_log2 = min_log2_tile_cols
    while cols_log2 < max_log2_tile_cols and r.f(1):
        cols_log2 += 1
    rows_log2 = max(min_log2_tiles - cols_log2, 0)
    while rows_log2 < max_log2_tile_rows and r.f(1):
        rows_log2 += 1
    if cols_log2 or rows_log2:
        r.f(cols_log2 + rows_log2)
        assert r.f(2) == 3
    return cols_log2, rows_log2


# ---- finite subexponential literals (spec 4.10.6 su / 5.9.25
# read_global_param; ref aom_wb_write_signed_primitive_refsubexpfin,
# EbEntropyCoding.c:3304-3453) -----------------------------------------

def _recenter_nonneg(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def _inv_recenter_nonneg(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _write_quniform(w: BitWriter, n: int, v: int) -> None:
    if n <= 1:
        return
    l = (n - 1).bit_length()
    m = (1 << l) - n
    if v < m:
        w.f(v, l - 1)
    else:
        w.f(m + ((v - m) >> 1), l - 1)
        w.f((v - m) & 1, 1)


def _read_quniform(r: BitReader, n: int) -> int:
    if n <= 1:
        return 0
    l = (n - 1).bit_length()
    m = (1 << l) - n
    v = r.f(l - 1)
    if v < m:
        return v
    return (v << 1) - m + r.f(1)


def _write_subexpfin(w: BitWriter, n: int, k: int, v: int) -> None:
    i = mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            _write_quniform(w, n - mk, v - mk)
            return
        if v >= mk + a:
            w.f(1, 1)
            i += 1
            mk += a
        else:
            w.f(0, 1)
            w.f(v - mk, b)
            return


def _read_subexpfin(r: BitReader, n: int, k: int) -> int:
    i = mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return _read_quniform(r, n - mk) + mk
        if r.f(1):
            i += 1
            mk += a
        else:
            return r.f(b) + mk


def _write_signed_subexp_ref(w: BitWriter, n: int, k: int, ref: int,
                             v: int) -> None:
    """signed value in [-(n-1), n-1] recentred on ref, subexp-coded."""
    ref += n - 1
    v += n - 1
    sn = (n << 1) - 1
    _write_subexpfin(w, sn, k, _recenter_finite(sn, ref, v))


def _read_signed_subexp_ref(r: BitReader, n: int, k: int, ref: int) -> int:
    ref += n - 1
    sn = (n << 1) - 1
    x = _read_subexpfin(r, sn, k)
    if (ref << 1) <= sn:
        v = _inv_recenter_nonneg(ref, x)
    else:
        v = sn - 1 - _inv_recenter_nonneg(sn - 1 - ref, x)
    return v - (n - 1)


def _recenter_finite(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _recenter_nonneg(r, v)
    return _recenter_nonneg(n - 1 - r, n - 1 - v)


# translation-only GM literal params with allow_high_precision_mv=0:
# abs bound 1<<(GM_ABS_TRANS_ONLY_BITS-1) = 256, coded at quarter-pel
# (prec_diff GM_TRANS_ONLY_PREC_DIFF+1 = 14; wmmat = mv8 << 13)
GM_TRANS_MAX = 1 << 8
SUBEXPFIN_K = 3


def write_frame_header_bits(sp: SequenceParams, fp: FrameParams) -> BitWriter:
    """uncompressed_header() for a shown keyframe or single-ref inter frame
    (spec 5.9.2; ref WriteFrameHeaderObu EbEntropyCoding.c:4214)."""
    w = BitWriter()
    w.f(0, 1)                    # show_existing_frame
    w.f(fp.frame_type, 2)
    w.f(int(fp.show_frame), 1)
    if not fp.show_frame:
        w.f(1, 1)                # showable_frame
    if not (fp.is_intra and fp.show_frame):
        w.f(0, 1)                # error_resilient_mode
    w.f(int(fp.disable_cdf_update), 1)
    if sp.screen_content:        # seq_force == SELECT
        w.f(int(fp.allow_screen_content), 1)
        if fp.allow_screen_content:
            # force_integer_mv (seq SELECT); intra frames force it to 1
            # after the read anyway (spec 5.9.2)
            w.f(int(fp.is_intra), 1)
    w.f(0, 1)                    # frame_size_override_flag
    if sp.enable_order_hint:
        w.f(fp.order_hint, sp.order_hint_bits)
    if not fp.is_intra:
        w.f(PRIMARY_REF_NONE, 3)  # primary_ref_frame (CDF reset per frame)
    if not (fp.frame_type == KEY_FRAME and fp.show_frame):
        w.f(fp.refresh_frame_flags, 8)
    if not fp.is_intra:
        if sp.enable_order_hint:
            w.f(0, 1)            # frame_refs_short_signaling
        for i in range(7):
            w.f(fp.ref_frame_idx[i], 3)
        w.f(0, 1)                # render_and_frame_size_different
        w.f(0, 1)                # allow_high_precision_mv
        w.f(0, 1)                # is_filter_switchable
        w.f(fp.interp_filter, 2)  # interpolation_filter
        w.f(int(fp.switchable_motion_mode), 1)  # is_motion_mode_switchable
        # use_ref_frame_mvs: seq enable_ref_frame_mvs = 0 -> no bit
    else:
        w.f(0, 1)                # render_and_frame_size_different
        if fp.allow_screen_content:   # UpscaledWidth == FrameWidth
            w.f(int(fp.allow_intrabc), 1)
    if not fp.disable_cdf_update:
        w.f(0, 1)                # disable_frame_end_update_cdf
    _tile_info_bits(w, sp, fp)
    # quantization_params
    w.f(fp.base_q_idx, 8)
    w.f(0, 1)                    # DeltaQYDc coded flag
    w.f(0, 1)                    # DeltaQUDc
    w.f(0, 1)                    # DeltaQUAc
    w.f(0, 1)                    # using_qmatrix
    w.f(0, 1)                    # segmentation_enabled
    if fp.base_q_idx > 0:
        w.f(1 if fp.delta_q_on else 0, 1)    # delta_q_present
        if fp.delta_q_on:
            w.f(fp.delta_q_res, 2)           # delta_q_res (log2)
    # loop_filter_params / cdef_params / lr_params are NOT coded when
    # allow_intrabc (spec 5.9.11/5.9.19/5.9.20: defaults, filters off)
    if not fp.allow_intrabc:
        lv = fp.filter_levels
        w.f(lv[0], 6)            # loop_filter_level[0]
        w.f(lv[1], 6)            # loop_filter_level[1]
        if lv[0] or lv[1]:
            w.f(lv[2], 6)        # loop_filter_level[2] (u)
            w.f(lv[3], 6)        # loop_filter_level[3] (v)
        w.f(0, 3)                # loop_filter_sharpness
        w.f(0, 1)                # loop_filter_delta_enabled
    if sp.enable_cdef and not fp.allow_intrabc:  # cdef_params (5.9.19)
        w.f(fp.cdef_damping - 3, 2)
        w.f(fp.cdef_bits, 2)
        for i in range(1 << fp.cdef_bits):
            yp, ys = fp.cdef_y_strengths[i]
            up_, us = fp.cdef_uv_strengths[i]
            w.f(yp, 4).f(ys, 2)
            w.f(up_, 4).f(us, 2)
    if sp.enable_restoration and not fp.allow_intrabc:  # lr (5.9.20)
        for p in range(3):
            w.f(fp.lr_types[p], 2)
        uses_lr = any(fp.lr_types)
        uses_chroma_lr = fp.lr_types[1] or fp.lr_types[2]
        if uses_lr:
            w.f(int(fp.lr_unit_shift > 0), 1)
            if fp.lr_unit_shift > 0:
                w.f(fp.lr_unit_shift - 1, 1)
            if uses_chroma_lr:   # 4:2:0
                w.f(fp.lr_uv_shift, 1)
    w.f(fp.tx_mode_select, 1)    # read_tx_mode (0 = LARGEST)
    if not fp.is_intra:
        w.f(int(fp.reference_select), 1)
    # skip_mode_params (spec 5.9.22): gate depends on ref order hints AND
    # reference_select (ref is_skip_mode_allowed only under
    # REFERENCE_MODE_SELECT, EbEntropyCoding.c:4036)
    if (not fp.is_intra and fp.reference_select
            and skip_mode_allowed(sp, fp.order_hint, fp.ref_order_hints)):
        w.f(0, 1)                # skip_mode_present = 0
    if not fp.is_intra and sp.enable_warped_motion:
        w.f(int(fp.allow_warped_motion), 1)
    w.f(int(fp.reduced_tx_set), 1)
    if not fp.is_intra:
        # global_motion_params (spec 5.9.24; TRANSLATION only)
        for i in range(7):
            t = fp.gm_types[i]
            w.f(int(t != 0), 1)              # is_global
            if t:
                w.f(int(t == 2), 1)          # is_rot_zoom
                if t != 2:
                    w.f(int(t == 1), 1)      # is_translation
            if t == 1:
                for c in range(2):           # row then col (ref wmmat[0/1])
                    _write_signed_subexp_ref(
                        w, GM_TRANS_MAX + 1, SUBEXPFIN_K, 0,
                        fp.gm_trans[i][c] >> 1)
    if sp.film_grain_present:
        _write_film_grain(w, fp)
    return w


def _write_film_grain(w: BitWriter, fp: FrameParams) -> None:
    """spec 5.9.30 film_grain_params (ref write_film_grain_params,
    EbEntropyCoding.c:3565)."""
    g = fp.film_grain
    if g is None or not g.apply_grain:
        w.f(0, 1)
        return
    w.f(1, 1)
    w.f(g.random_seed, 16)
    if fp.frame_type == INTER_FRAME:
        w.f(1, 1)                # update_grain (no param inheritance yet)
    w.f(g.num_y_points, 4)
    for x, s in g.scaling_points_y:
        w.f(x, 8).f(s, 8)
    w.f(int(g.chroma_scaling_from_luma), 1)
    coded_chroma = not (g.chroma_scaling_from_luma
                        or g.num_y_points == 0)   # 4:2:0 rule
    if coded_chroma:
        w.f(g.num_cb_points, 4)
        for x, s in g.scaling_points_cb:
            w.f(x, 8).f(s, 8)
        w.f(g.num_cr_points, 4)
        for x, s in g.scaling_points_cr:
            w.f(x, 8).f(s, 8)
    w.f(g.scaling_shift - 8, 2)
    w.f(g.ar_coeff_lag, 2)
    npos = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
    if g.num_y_points:
        for i in range(npos):
            w.f(g.ar_coeffs_y[i] + 128, 8)
    nposc = npos + (1 if g.num_y_points else 0)
    if g.num_cb_points or g.chroma_scaling_from_luma:
        for i in range(nposc):
            w.f(g.ar_coeffs_cb[i] + 128, 8)
    if g.num_cr_points or g.chroma_scaling_from_luma:
        for i in range(nposc):
            w.f(g.ar_coeffs_cr[i] + 128, 8)
    w.f(g.ar_coeff_shift - 6, 2)
    w.f(g.grain_scale_shift, 2)
    if g.num_cb_points:
        w.f(g.cb_mult, 8).f(g.cb_luma_mult, 8).f(g.cb_offset, 9)
    if g.num_cr_points:
        w.f(g.cr_mult, 8).f(g.cr_luma_mult, 8).f(g.cr_offset, 9)
    w.f(int(g.overlap_flag), 1)
    w.f(int(g.clip_to_restricted_range), 1)


def _parse_film_grain(r: BitReader, is_intra: bool):
    raise NotImplementedError("film grain is not ported")


@dataclass
class ShowExisting:
    """show_existing_frame header: display the frame in slot."""
    slot: int


def parse_frame_header_bits(r: BitReader, sp: SequenceParams,
                            slot_order_hints=None):
    if r.f(1):                    # show_existing_frame
        return ShowExisting(r.f(3))
    frame_type = r.f(2)
    assert frame_type in (KEY_FRAME, INTER_FRAME), frame_type
    is_intra = frame_type == KEY_FRAME
    show_frame = bool(r.f(1))
    if not show_frame:
        assert r.f(1) == 1, "showable_frame"
    if not (is_intra and show_frame):
        assert r.f(1) == 0, "error_resilient_mode"
    disable_cdf_update = bool(r.f(1))
    allow_sc = False
    if sp.screen_content:         # seq_force == SELECT
        allow_sc = bool(r.f(1))
        if allow_sc:
            fim = bool(r.f(1))    # force_integer_mv (SELECT)
            assert fim or not is_intra
    assert r.f(1) == 0  # frame_size_override
    order_hint = r.f(sp.order_hint_bits) if sp.enable_order_hint else 0
    refresh = 0xFF
    ref_idx = (0,) * 7
    ref_hints = (0,) * 7
    if not is_intra:
        assert r.f(3) == PRIMARY_REF_NONE, "primary_ref_frame"
    if not (frame_type == KEY_FRAME and show_frame):
        refresh = r.f(8)
    if not is_intra:
        if sp.enable_order_hint:
            assert r.f(1) == 0, "frame_refs_short_signaling"
        ref_idx = tuple(r.f(3) for _ in range(7))
        if slot_order_hints is not None:
            ref_hints = tuple(slot_order_hints[i] for i in ref_idx)
        assert r.f(1) == 0  # render size
        assert r.f(1) == 0  # allow_high_precision_mv
        assert r.f(1) == 0  # is_filter_switchable
        interp_filter = r.f(2)
        switchable_mm = bool(r.f(1))   # is_motion_mode_switchable
    else:
        interp_filter = 0
        switchable_mm = False
        assert r.f(1) == 0  # render size
    allow_intrabc = False
    if is_intra and allow_sc:
        allow_intrabc = bool(r.f(1))
    if not disable_cdf_update:
        assert r.f(1) == 0  # disable_frame_end_update_cdf
    cols_log2, rows_log2 = _parse_tile_info(r, sp)
    base_q_idx = r.f(8)
    assert r.f(1) == 0 and r.f(1) == 0 and r.f(1) == 0  # q deltas
    assert r.f(1) == 0  # qmatrix
    assert r.f(1) == 0  # segmentation
    delta_q_res = 0
    delta_q_present = False
    if base_q_idx > 0 and r.f(1):   # delta_q_present
        delta_q_present = True
        delta_q_res = r.f(2)        # 0..3 all spec-legal
    l0 = l1 = lu = lv_ = 0
    if not allow_intrabc:
        l0, l1 = r.f(6), r.f(6)
        if l0 or l1:
            lu, lv_ = r.f(6), r.f(6)
        assert r.f(3) == 0  # sharpness
        assert r.f(1) == 0  # lf delta enabled
    cdef_damping, cdef_bits = 3, 2
    y_str = [(0, 0)] * 4
    uv_str = [(0, 0)] * 4
    if sp.enable_cdef and not allow_intrabc:
        cdef_damping = r.f(2) + 3
        cdef_bits = r.f(2)
        y_str, uv_str = [], []
        for _ in range(1 << cdef_bits):
            y_str.append((r.f(4), r.f(2)))
            uv_str.append((r.f(4), r.f(2)))
    lr_types = (0, 0, 0)
    lr_unit_shift = 0
    lr_uv_shift = 0
    if sp.enable_restoration and not allow_intrabc:
        lr_types = tuple(r.f(2) for _ in range(3))
        if any(lr_types):
            if r.f(1):
                lr_unit_shift = 1 + r.f(1)
            if lr_types[1] or lr_types[2]:
                lr_uv_shift = r.f(1)
    tx_mode_select = r.f(1)
    reference_select = False
    if not is_intra:
        reference_select = bool(r.f(1))
    if (not is_intra and reference_select
            and skip_mode_allowed(sp, order_hint, ref_hints)):
        assert r.f(1) == 0, "skip_mode_present"
    allow_warped = False
    if not is_intra and sp.enable_warped_motion:
        allow_warped = bool(r.f(1))
    reduced_tx_set = bool(r.f(1))
    gm_types = [0] * 7
    gm_trans = [(0, 0)] * 7
    if not is_intra:
        for i in range(7):
            if r.f(1):                       # is_global
                rz = r.f(1)
                assert rz == 0, "ROTZOOM global motion not produced"
                assert r.f(1) == 1, "AFFINE global motion not produced"
                row = _read_signed_subexp_ref(
                    r, GM_TRANS_MAX + 1, SUBEXPFIN_K, 0) << 1
                col = _read_signed_subexp_ref(
                    r, GM_TRANS_MAX + 1, SUBEXPFIN_K, 0) << 1
                gm_types[i] = 1
                gm_trans[i] = (row, col)
    grain = None
    if sp.film_grain_present:
        grain = _parse_film_grain(r, is_intra)
    return FrameParams(base_q_idx, disable_cdf_update, reduced_tx_set,
                       tx_mode_select, cols_log2, rows_log2, frame_type,
                       refresh, ref_idx, show_frame, order_hint, ref_hints,
                       reference_select, (l0, l1, lu, lv_),
                       cdef_damping, cdef_bits, tuple(y_str), tuple(uv_str),
                       grain, lr_types, lr_unit_shift, lr_uv_shift,
                       interp_filter, tuple(gm_types), tuple(gm_trans),
                       switchable_motion_mode=switchable_mm,
                       allow_warped_motion=allow_warped,
                       allow_screen_content=allow_sc,
                       allow_intrabc=allow_intrabc,
                       delta_q_res=delta_q_res,
                       delta_q_present=delta_q_present)


def tile_starts(sp: SequenceParams, cols_log2: int, rows_log2: int):
    """Uniform tile grid mi start/stop lists (spec tile_info uniform
    spacing: ceil-divided SB spans, last tile smaller)."""
    sb_cols = (sp.mi_cols + 15) >> 4
    sb_rows = (sp.mi_rows + 15) >> 4
    tw = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
    th = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
    col_mi = [min(s * 16, sp.mi_cols) for s in range(0, sb_cols + tw, tw)]
    row_mi = [min(s * 16, sp.mi_rows) for s in range(0, sb_rows + th, th)]
    cols = [(col_mi[i], col_mi[i + 1]) for i in range(len(col_mi) - 1)
            if col_mi[i] < col_mi[i + 1]]
    rows = [(row_mi[i], row_mi[i + 1]) for i in range(len(row_mi) - 1)
            if row_mi[i] < row_mi[i + 1]]
    return rows, cols


def assemble_tile_group(tiles: list) -> bytes:
    """Concatenate tile payloads with 4-byte little-endian size fields
    on all but the last (tile_size_bytes_minus_1 = 3 in tile_info)."""
    out = b""
    for i, t in enumerate(tiles):
        if i + 1 < len(tiles):
            out += (len(t) - 1).to_bytes(4, "little")
        out += t
    return out


def write_show_existing(slot: int) -> bytes:
    """OBU_FRAME_HEADER displaying the frame stored in ref slot
    (spec show_existing_frame; ref EbPacketizationProcess.c show-existing
    temporal units for hierarchical GOPs)."""
    w = BitWriter()
    w.f(1, 1)          # show_existing_frame
    w.f(slot, 3)       # frame_to_show_map_idx
    w.trailing_bits()
    return temporal_delimiter() + wrap_obu(OBU_FRAME_HEADER, w.data())


def write_frame_obu(sp: SequenceParams, fp: FrameParams,
                    tile_payload: bytes) -> bytes:
    """OBU_FRAME = frame header + byte alignment + tile group."""
    w = write_frame_header_bits(sp, fp)
    w.byte_align()
    header = w.data()
    rows, cols = tile_starts(sp, fp.tile_cols_log2, fp.tile_rows_log2)
    n_tiles = len(rows) * len(cols)
    tg = BitWriter()
    if n_tiles > 1:
        tg.f(0, 1)  # tile_start_and_end_present_flag
        tg.byte_align()
        return wrap_obu(OBU_FRAME, header + tg.data() + tile_payload)
    return wrap_obu(OBU_FRAME, header + tile_payload)


def split_obus(data: bytes):
    """Yield (obu_type, payload) from a byte stream of size-field OBUs."""
    pos = 0
    while pos < len(data):
        byte0 = data[pos]
        obu_type = (byte0 >> 3) & 0xF
        has_ext = (byte0 >> 2) & 1
        has_size = (byte0 >> 1) & 1
        pos += 1 + has_ext
        assert has_size, "size field required"
        size, pos = read_leb128(data, pos)
        yield obu_type, data[pos : pos + size]
        pos += size
