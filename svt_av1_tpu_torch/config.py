"""Encoder configuration (the port's copy of svt_av1_tpu.config).

Mirrors the public configuration surface of the reference encoder
(``EbSvtAv1Enc.h:34-377`` ``EbSvtAv1EncConfiguration``), re-expressed as a
typed Python dataclass.  Fields that the TPU build does not implement yet
are present (API parity) and validated, but raise ``NotImplementedError``
when enabled, so users get a clear signal instead of silent wrong output.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# --- enums (ref: EbSvtAv1Enc.h / EbDefinitions.h) ---------------------------

RC_MODE_CQP = 0       # constant QP             (ref rate_control_mode=0)
RC_MODE_MODEL = 1     # model-based estimator    (ref rate_control_mode=1)
RC_MODE_VBR = 2       # variable bitrate        (ref rate_control_mode=2)
RC_MODE_CVBR = 3      # constrained VBR         (ref rate_control_mode=3)

PRED_STRUCT_LOW_DELAY_P = 0   # ref EB_PRED_LOW_DELAY_P
PRED_STRUCT_LOW_DELAY_B = 1   # ref EB_PRED_LOW_DELAY_B
PRED_STRUCT_RANDOM_ACCESS = 2  # ref EB_PRED_RANDOM_ACCESS

INTRA_PERIOD_INTRA_ONLY = -2  # every frame is a keyframe

_SUPPORTED_PRESETS = tuple(range(9))  # enc_mode 0..8, ref user guide :126


@dataclass
class EncoderConfig:
    """Full encoder configuration (ref ``EbSvtAv1EncConfiguration``)."""

    # --- input geometry (ref EbSvtAv1Enc.h:96-135) ---
    width: int = 0
    height: int = 0
    bit_depth: int = 8                # 8 or 10 (ref encoder_bit_depth)
    color_format: str = "yuv420"      # only 4:2:0, like the reference
    frame_rate_num: int = 30
    frame_rate_den: int = 1

    # --- coding structure (ref :136-180) ---
    enc_mode: int = 8                 # preset 0(quality)..8(speed)
    intra_period: int = INTRA_PERIOD_INTRA_ONLY  # -2: intra-only, -1: first only
    pred_structure: int = PRED_STRUCT_RANDOM_ACCESS
    hierarchical_levels: int = 3      # mini-GOP 2^n (ref :141)
    super_block_size: int = 64        # 64 or 128 (ref :135)
    look_ahead_distance: int = 0      # 0..120 (ref :160)
    scene_change_detection: bool = True  # ref scd_mode: insert keyframes
                                         # at detected cuts (inter modes)

    # --- rate control (ref :200-260) ---
    rate_control_mode: int = RC_MODE_CQP
    qp: int = 50                      # 0..63 quantizer index base (ref qp)
    target_bit_rate: int = 0
    min_qp_allowed: int = 0
    max_qp_allowed: int = 63
    # adaptive quantization (ref --adaptive-quantization levels):
    # 0/False off; 1/True frame-level q offset from picture analysis;
    # 2 adds per-superblock delta-q on hier-B inter frames (spec 5.9.17
    # deltas; variance-masking maps; C++ and Python entropy both code
    # the delta_q symbol)
    enable_adaptive_quantization: int = 0

    # --- AV1 tools (ref :260-345) ---
    tile_columns_log2: int = 0
    tile_rows_log2: int = 0
    enable_deblocking: bool = True    # in-loop deblocking (DLF)
    enable_cdef: bool = True     # CDEF in-loop filter (CQP only for now)
    enable_restoration: bool = False
    enable_film_grain: int = 0        # 0 off; 1..50 grain strength (ref
                                      # film_grain_denoise_strength);
                                      # -1 = estimate from source (ref
                                      # noise_model.c flat-block AR fit)
    # screen content (ref scene_content_mode 0/1/2: off/on/auto-detect,
    # sc detection EbPictureDecisionProcess.c:650): intra frames code
    # intra-block-copy blocks found by hash ME (pipeline/ibc.py)
    screen_content_mode: int = 0
    enable_warped_motion: bool = False
    # frame-level interpolation filter: -1 auto (open-loop content
    # decision), 0 EIGHTTAP_REGULAR, 1 EIGHTTAP_SMOOTH, 2 EIGHTTAP_SHARP
    # (ref interpolation filter search, EbProductCodingLoop.c:1138)
    interp_filter: int = -1
    # global motion (TRANSLATION): open-loop per-frame estimation +
    # GLOBALMV coding on IPPP chains (ref GM detection,
    # EbInitialRateControlProcess.c:252; gm params spec 5.9.24)
    enable_global_motion: bool = True
    compound_mode: int = 1            # 0 off, 1 COMPOUND_AVERAGE in
                                      # hier-B (ref compound_level)
    # multi-reference prediction (hier-B): interior frames add the
    # mini-GOP base as a third single-prediction ref (LAST + BWDREF +
    # ALTREF; ref Av1GenerateRpsInfo 4-slot lists,
    # EbPictureDecisionProcess.c:1094).  -1 auto: on for enc_mode <= 7,
    # off at preset 8 (one extra ME pipeline per frame); 0/1 force.
    multi_ref: int = -1
    disable_cdf_update: bool = False  # keep per-symbol CDF adaptation on

    # --- TPU build specific ---
    fixed_partition_size: int = 0     # 0 = adaptive partition RDO;
                                      # 8/16/32/64 = force uniform partition
    intra_modes: Tuple[str, ...] = ("ALL",)   # full 13-mode base set
    entropy_backend: str = "auto"     # "auto" | "cpp" | "python"
    device_batch: int = 1             # frames encoded per device dispatch
                                      # (multi-stream/lookahead batching)

    # --- observability (ref stat_report EbSvtAv1Enc.h:343) ---
    stat_report: bool = False
    recon_output: bool = True     # transfer recon to host (eb_svt_get_recon);
                                  # off = less device->host traffic

    # --- multi-host (ref channel_id / active_channel_count :292) ---
    # >1 routes encoding through parallel.gop.GopShardedEncoder: GOPs
    # (intra_period+1 frames each) encode in lockstep over a device
    # mesh (see app/enc_app.py --gop-shards)
    num_gop_shards: int = 1

    def __post_init__(self) -> None:
        self.validate()

    # -- validation mirrors eb_svt_enc_set_parameter's checks ----------------
    def validate(self) -> None:
        if not (64 <= self.width <= 4096) or not (64 <= self.height <= 2304):
            if self.width or self.height:  # allow zero-init then set
                raise ValueError(
                    f"resolution {self.width}x{self.height} outside 64x64..4096x2304"
                )
        if self.bit_depth not in (8, 10):
            raise ValueError("bit_depth must be 8 or 10")
        if self.color_format != "yuv420":
            raise ValueError("only yuv420 is supported (as in the reference)")
        if self.enc_mode not in _SUPPORTED_PRESETS:
            raise ValueError("enc_mode (preset) must be 0..8")
        if not (0 <= self.qp <= 63):
            raise ValueError("qp must be 0..63")
        if self.rate_control_mode not in (RC_MODE_CQP, RC_MODE_MODEL,
                                          RC_MODE_VBR, RC_MODE_CVBR):
            raise NotImplementedError(
                "rate_control_mode must be CQP(0)/model(1)/VBR(2)/CVBR(3)")
        if self.rate_control_mode != RC_MODE_CQP and self.target_bit_rate <= 0:
            raise ValueError("VBR/CVBR require target_bit_rate > 0")
        if self.super_block_size not in (64, 128):
            raise ValueError("super_block_size must be 64 or 128")
        if self.fixed_partition_size not in (0, 8, 16, 32, 64):
            raise ValueError("fixed_partition_size must be 0/8/16/32/64")
        if self.interp_filter not in (-1, 0, 1, 2):
            raise ValueError(
                "interp_filter must be -1 (auto) / 0 regular / 1 smooth "
                "/ 2 sharp")
        if not (-1 <= int(self.enable_film_grain) <= 50):
            raise ValueError("enable_film_grain must be -1 (auto) or 0..50")
        if self.enable_warped_motion:
            # WARPED_CAUSAL is a host post-pass over the P-step outputs
            # (pipeline/warp_pass.py); current scope: IPPP chains,
            # frame-wide tiles, no LR in the same stream
            if self.pred_structure != PRED_STRUCT_LOW_DELAY_P \
                    or self.intra_only:
                raise NotImplementedError(
                    "enable_warped_motion requires pred_structure=0 (IPPP)")
            if self.tile_columns_log2 or self.tile_rows_log2:
                raise NotImplementedError(
                    "enable_warped_motion with tiles not yet supported")
            if self.enable_restoration:
                raise NotImplementedError(
                    "enable_warped_motion with restoration not yet "
                    "supported")
        if self.screen_content_mode:
            if self.screen_content_mode not in (1, 2):
                raise ValueError("screen_content_mode must be 0/1/2")
            # v1 scope: 8-bit, single tile (the hash-ME DV validity is
            # computed against a frame-wide tile), no LR on intra frames
            # (allow_intrabc turns in-loop filters off there anyway)
            if self.bit_depth != 8:
                raise NotImplementedError(
                    "screen_content_mode requires bit_depth=8")
            if self.tile_columns_log2 or self.tile_rows_log2:
                raise NotImplementedError(
                    "screen_content_mode with tiles not yet supported")
        # round-1 capability gates — explicit, not silent
        unimplemented = {
            "super_block_size=128": self.super_block_size == 128,
        }
        enabled = [k for k, v in unimplemented.items() if v]
        if enabled:
            raise NotImplementedError(
                f"not yet implemented in the TPU build: {', '.join(enabled)}"
            )

    # -- derived geometry -----------------------------------------------------
    @property
    def sb_size(self) -> int:
        return self.super_block_size

    @property
    def sb_cols(self) -> int:
        return (self.width + self.sb_size - 1) // self.sb_size

    @property
    def sb_rows(self) -> int:
        return (self.height + self.sb_size - 1) // self.sb_size

    @property
    def mi_cols(self) -> int:
        """4x4 mode-info columns (AV1 spec: 2*ceil(w/8))."""
        return 2 * ((self.width + 7) >> 3)

    @property
    def mi_rows(self) -> int:
        return 2 * ((self.height + 7) >> 3)

    @property
    def intra_only(self) -> bool:
        return self.intra_period == INTRA_PERIOD_INTRA_ONLY

    def replace(self, **kw) -> "EncoderConfig":
        return dataclasses.replace(self, **kw)


def check_slice(cfg: EncoderConfig) -> None:
    """Raise ``NotImplementedError`` naming every enabled setting that the
    port does not run yet.

    The port covers CQP and rate control (1: the bits-model controller;
    2 / 3: VBR / constrained VBR) at 8 or 10 bits and presets 0-8 (0-7:
    the full-RD inter merge and the 16x16 keyframe partition search;
    multi_ref -1/0/1, a third reference on hier-B interior frames; 0-5:
    the inter tx-type search, rectangular inter leaves and the rich intra
    mode set):
    all-intra streams, low-delay-P (IPPP) chains with one reference and
    global motion, low-delay B (``pred_structure=1``: LAST + GOLDEN) and
    hierarchical-B random access (``pred_structure=2``, with or without
    compound prediction), with deblocking, CDEF and loop restoration
    (Wiener / self-guided, a host stage), adaptive quantization (1: a
    frame-level q offset; 2: plus per-superblock delta-q on hier-B
    inter frames), scene-change detection (the flat structures; hier-B
    ignores it, as the reference package does), look-ahead q offsets
    (the flat structures) and tiled inter frames; all-intra batches of
    ``device_batch`` frames, and ``num_gop_shards`` (which, as in the
    reference package, only the CLI's GopShardedEncoder reads).
    Everything else is refused by name rather than encoded differently
    from the reference package.
    """
    inter = not cfg.intra_only
    hier = inter and cfg.pred_structure == PRED_STRUCT_RANDOM_ACCESS
    gates = {
        "enable_warped_motion": bool(cfg.enable_warped_motion),
        "screen_content_mode (IBC)": bool(cfg.screen_content_mode),
        "enable_film_grain": bool(cfg.enable_film_grain),
        "look_ahead_distance>0 with pred_structure=2":
            hier and cfg.look_ahead_distance > 0,
    }
    enabled = [k for k, v in gates.items() if v]
    if enabled:
        raise NotImplementedError(
            f"not yet ported to svt_av1_tpu_torch: {', '.join(enabled)}")
