"""CDF storage and per-symbol adaptation (AV1 spec §8.4 update process).

CDF convention: arrays of length nsyms+1, int32.
  icdf[i]      = 32768 - P(symbol <= i) * 32768   for i < nsyms  (Q15)
  icdf[nsyms-1] == 0 always
  icdf[nsyms]  = adaptation counter (0..32), the spec's cdf[N] slot

This matches the layout the range coder consumes directly and the storage
the reference uses (EbCabacContextModel.h AOM_ICDF/AOM_CDFn macros).

``FrameContext`` bundles every per-frame adaptive CDF table the TPU build
codes with, initialized from the normative default tables (tables/) —
ref parity: init_mode_probs / av1_default_coef_probs
(EbCabacContextModel.c:964-1011, :4450-4460).
"""

from __future__ import annotations

import numpy as np

from svt_av1_tpu_torch import tables


def make_icdf(nsyms: int) -> np.ndarray:
    """Uniform inverse CDF with counter slot (matches spec uniform init)."""
    cum = np.round(32768.0 * np.arange(1, nsyms + 1) / nsyms).astype(np.int64)
    out = np.zeros(nsyms + 1, dtype=np.int32)
    out[:nsyms] = 32768 - cum
    return out


def cum_to_icdf(cum_row: np.ndarray, nsyms: int) -> np.ndarray:
    """Convert a cumulative-prob row (tables/ convention) to icdf+counter."""
    out = np.zeros(nsyms + 1, dtype=np.int32)
    out[:nsyms] = 32768 - cum_row[:nsyms].astype(np.int32)
    return out


_NSYMS2SPEED = [0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2]


def update_icdf(icdf: np.ndarray, val: int, nsyms: int) -> None:
    """In-place exponential-decay CDF update (spec §8.4 / libaom update_cdf)."""
    count = int(icdf[nsyms])
    rate = 3 + (count > 15) + (count > 31) + _NSYMS2SPEED[nsyms]
    tmp = 32768
    for i in range(nsyms - 1):
        if i == val:
            tmp = 0
        c = int(icdf[i])
        if tmp < c:
            icdf[i] = c - ((c - tmp) >> rate)
        else:
            icdf[i] = c + ((tmp - c) >> rate)
    icdf[nsyms] = count + (count < 32)


class _DvContext:
    """nmv_context twin for intra-block-copy DVs (libaom ndvc)."""


class FrameContext:
    """All adaptive symbol CDFs for one frame/tile.

    Structure mirrors the reference FRAME_CONTEXT (EbCabacContextModel.h)
    restricted to the syntax the TPU build currently emits; grows as tools
    are added.  Encoder and mirror decoder share this class — single source
    of truth for initialization and adaptation.
    """

    def __init__(self, base_q_idx: int) -> None:
        t = tables.spec_tables()
        qctx = self._q_ctx(base_q_idx)

        def conv(arr: np.ndarray, nsyms_map=None) -> np.ndarray:
            """tables/ cumulative array [..., max_nsym] -> icdf [..., max_nsym+1]."""
            shp = arr.shape
            out = np.zeros(shp[:-1] + (shp[-1] + 1,), dtype=np.int32)
            out[..., : shp[-1]] = 32768 - arr.astype(np.int32)
            return out

        # mode info
        self.kf_y_mode = conv(t["default_kf_y_mode_cdf"])          # [5][5][14]
        self.uv_mode = conv(t["default_uv_mode_cdf"])              # [2][13][15]
        self.angle_delta = conv(t["default_angle_delta_cdf"])      # [8][8]
        self.cfl_sign = conv(t["default_cfl_sign_cdf"])[0]         # [9]
        self.cfl_alpha = conv(t["default_cfl_alpha_cdf"])          # [6][17]
        self.partition = conv(t["default_partition_cdf"])          # [20][11]
        self.delta_q = conv(t["default_delta_q_cdf"])[0]           # [5]
        self.skip = conv(t["default_skip_cdfs"])                   # [3][3]
        self.intra_ext_tx = conv(t["default_intra_ext_tx_cdf"])    # [3][4][13][17]
        self.tx_size = conv(t["default_tx_size_cdf"])              # [4][3][4]

        # inter mode info (ref init_mode_probs, EbCabacContextModel.c:964+)
        self.y_mode = conv(t["default_if_y_mode_cdf"])             # [4][14]
        self.newmv = conv(t["default_newmv_cdf"])                  # [6][3]
        self.zeromv = conv(t["default_zeromv_cdf"])                # [2][3]
        self.refmv = conv(t["default_refmv_cdf"])                  # [6][3]
        self.drl = conv(t["default_drl_cdf"])                      # [3][3]
        self.intra_inter = conv(t["default_intra_inter_cdf"])      # [4][3]
        self.single_ref = conv(t["default_single_ref_cdf"])        # [3][6][3]
        self.comp_inter = conv(t["default_comp_inter_cdf"])        # [5][3]
        self.comp_ref_type = conv(t["default_comp_ref_type_cdf"])  # [5][3]
        self.comp_ref = conv(t["default_comp_ref_cdf"])            # [3][3][3]
        self.comp_bwdref = conv(t["default_comp_bwdref_cdf"])      # [3][2][3]
        self.inter_compound_mode = conv(
            t["default_inter_compound_mode_cdf"])                  # [8][9]
        self.skip_mode = conv(t["default_skip_mode_cdfs"])         # [3][3]
        self.switchable_interp = conv(t["default_switchable_interp_cdf"])
        self.wiener_restore = conv(t["default_wiener_restore_cdf"])[0]
        self.sgrproj_restore = conv(t["default_sgrproj_restore_cdf"])[0]
        self.switchable_restore = conv(
            t["default_switchable_restore_cdf"])[0]
        self.inter_ext_tx = conv(t["default_inter_ext_tx_cdf"])    # [4][4][17]
        self.motion_mode = conv(t["default_motion_mode_cdf"])      # [22][4]
        self.obmc = conv(t["default_obmc_cdf"])                    # [22][3]
        # MV coding (nmv_context; ref EbCabacContextModel.c:899)
        self.nmv_joints = conv(t["nmv_joints"][None])[0]           # [5]
        self.nmv_classes = conv(t["nmv_classes"])                  # [2][12]
        self.nmv_class0_fp = conv(t["nmv_class0_fp"])              # [2][2][5]
        self.nmv_fp = conv(t["nmv_fp"])                            # [2][5]
        self.nmv_sign = conv(t["nmv_sign"])                        # [2][3]
        self.nmv_class0_hp = conv(t["nmv_class0_hp"])              # [2][3]
        self.nmv_hp = conv(t["nmv_hp"])                            # [2][3]
        self.nmv_class0 = conv(t["nmv_class0"])                    # [2][3]
        self.nmv_bits = conv(t["nmv_bits"])                        # [2][10][3]

        # intra block copy: use flag + a SEPARATE nmv instance for DVs
        # (ref FRAME_CONTEXT intrabc_cdf / ndvc,
        # EbCabacContextModel.c:821,1016 — same defaults, adapted apart)
        self.intrabc = conv(t["default_intrabc_cdf"])[0]           # [3]
        self.dv = _DvContext()
        for n in ("nmv_joints", "nmv_classes", "nmv_class0_fp", "nmv_fp",
                  "nmv_sign", "nmv_class0_hp", "nmv_hp", "nmv_class0",
                  "nmv_bits"):
            setattr(self.dv, n, getattr(self, n).copy())

        # coefficient coding (q-dependent defaults)
        self.txb_skip = conv(t["av1_default_txb_skip_cdfs"][qctx])       # [5][13][3]
        self.dc_sign = conv(t["av1_default_dc_sign_cdfs"][qctx])         # [2][3][3]
        self.eob_extra = conv(t["av1_default_eob_extra_cdfs"][qctx])     # [5][2][22][3]
        self.coeff_br = conv(t["av1_default_coeff_lps_multi_cdfs"][qctx])  # [5][2][21][5]
        self.coeff_base = conv(t["av1_default_coeff_base_multi_cdfs"][qctx])  # [5][2][42][5]
        self.coeff_base_eob = conv(
            t["av1_default_coeff_base_eob_multi_cdfs"][qctx])              # [5][2][4][4]
        self.eob_pt = {
            n: conv(t[f"av1_default_eob_multi{n}_cdfs"][qctx])
            for n in (16, 32, 64, 128, 256, 512, 1024)
        }  # each [2][2][k+1]

    @staticmethod
    def _q_ctx(base_q_idx: int) -> int:
        """TOKEN_CDF_Q_CTXS bucket (spec get_q_ctx / av1_get_adapted...)."""
        if base_q_idx <= 20:
            return 0
        if base_q_idx <= 60:
            return 1
        if base_q_idx <= 120:
            return 2
        return 3
