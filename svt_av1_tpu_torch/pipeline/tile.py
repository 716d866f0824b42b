"""Host entropy stage: tile writer (and its exact mirror lives in
decoder/decode.py, sharing every context rule via entropy.syntax).

Walks superblocks in raster order, the partition tree in Z-order (spec
decode_partition order), writing for each 8x8 leaf: skip, y mode, angle
delta (directional), uv mode, then per-plane coefficients.

Reference parity: EntropyCodingKernel per-SB write_sb loop
(EbEntropyCodingProcess.c:561, EbEntropyCoding.c:5294 write_sb,
EncodePartitionAv1 :934).
"""

from __future__ import annotations

import numpy as np

from svt_av1_tpu_torch.entropy import mvp as MVP
from svt_av1_tpu_torch.entropy import syntax as S
from svt_av1_tpu_torch.entropy.cdf_model import FrameContext, update_icdf
from svt_av1_tpu_torch.entropy.range_coder import RangeEncoder
from svt_av1_tpu_torch.ops import transforms as T

SB_MI = 16          # 64x64 superblock in 4x4 units
LEAF_MI = 2         # 8x8 leaf


def _partition_nsyms(n4: int) -> int:
    """Symbol count of the partition cdf at this square size."""
    if n4 == 2:       # 8x8
        return 4
    if n4 == 32:      # 128x128
        return 8
    return 10


def write_partition_symbol(enc, fc: FrameContext, tc: S.TileContexts,
                           r4: int, c4: int, n4: int, p: int) -> None:
    """ref EncodePartitionAv1 (incl. edge-forced binary forms)."""
    half = n4 >> 1
    has_rows = (r4 + half) < tc.mi_rows
    has_cols = (c4 + half) < tc.mi_cols
    bsl = (n4 >> 1).bit_length() - 1   # log2(n4) - 1: 8x8 -> 0 ... 128 -> 4
    ctx = tc.partition_ctx(r4, c4, bsl)
    cdf = fc.partition[ctx]
    nsym = _partition_nsyms(n4)
    if not has_rows and not has_cols:
        assert p == S.PARTITION_SPLIT
        return
    if has_rows and has_cols:
        enc.encode_symbol(p, cdf, nsym)
        update_icdf(cdf, p, nsym)
        return
    # derived binary cdf (does not adapt)
    bin_icdf = _split_binary_icdf(cdf, nsym, vertical=not has_rows)
    enc.encode_symbol(int(p == S.PARTITION_SPLIT), bin_icdf, 2)


def _split_binary_icdf(cdf: np.ndarray, nsym: int, vertical: bool
                       ) -> np.ndarray:
    """ref partition_gather_{vert,horz}_alike on icdf-stored tables."""
    def prob(e):
        if e >= nsym:
            return 0
        hi = 32768 if e == 0 else int(cdf[e - 1])
        return hi - int(cdf[e])

    if vertical:
        elems = [S.PARTITION_VERT, S.PARTITION_SPLIT, S.PARTITION_HORZ_A,
                 S.PARTITION_VERT_A, S.PARTITION_VERT_B, S.PARTITION_VERT_4]
    else:
        elems = [S.PARTITION_HORZ, S.PARTITION_SPLIT, S.PARTITION_HORZ_A,
                 S.PARTITION_HORZ_B, S.PARTITION_VERT_A, S.PARTITION_HORZ_4]
    psum = sum(prob(e) for e in elems)
    # icdf form: [32768 - P(sym0), 0, counter]
    return np.array([psum, 0, 0], np.int32)


def read_partition_symbol(dec, fc: FrameContext, tc: S.TileContexts,
                          r4: int, c4: int, n4: int) -> int:
    half = n4 >> 1
    has_rows = (r4 + half) < tc.mi_rows
    has_cols = (c4 + half) < tc.mi_cols
    bsl = (n4 >> 1).bit_length() - 1
    ctx = tc.partition_ctx(r4, c4, bsl)
    cdf = fc.partition[ctx]
    nsym = _partition_nsyms(n4)
    if not has_rows and not has_cols:
        return S.PARTITION_SPLIT
    if has_rows and has_cols:
        p = dec.decode_symbol(cdf, nsym)
        update_icdf(cdf, p, nsym)
        return p
    bin_icdf = _split_binary_icdf(cdf, nsym, vertical=not has_rows)
    is_split = dec.decode_symbol(bin_icdf, 2)
    if is_split:
        return S.PARTITION_SPLIT
    return S.PARTITION_HORZ if not has_rows else S.PARTITION_VERT


# ---------------------------------------------------------------------------

class TileWriter:
    """Encodes one tile from device-produced per-block data (P=8 uniform)."""

    def __init__(self, fc: FrameContext, mi_rows: int, mi_cols: int,
                 qindex: int, reduced_tx_set: bool = True,
                 lr=None, lr_off=(0, 0), frame_mi=None) -> None:
        self.fc = fc
        self.tc = S.TileContexts(mi_rows, mi_cols)
        # tile origin + frame mi dims for frame-absolute RU mapping in
        # _write_lr (spec read_lr uses MiRow/MiCol, which are
        # frame-absolute; per-tile ref resets stay per-instance)
        self.lr_off = lr_off
        self.frame_mi = frame_mi or (mi_rows, mi_cols)
        self.enc = RangeEncoder()
        self.qindex = qindex
        self.reduced_tx_set = reduced_tx_set
        self.inter = False
        self.cdef_idx = None     # [nsb_h, nsb_w] per-64x64 strength index
        self.cdef_bits = 2
        self._cdef_done = False
        # loop restoration: per-plane list [lr_y, lr_u, lr_v] (None =
        # RESTORE_NONE), each {"unit" (plane samples), "type" (2 wiener /
        # 3 sgrproj), "use", "taps"/"ep"+"xqd"}; per-SB RU syntax is
        # interleaved at SB starts (spec read_lr)
        self.lr = lr
        self._lr_ref = ([list(S.WIENER_MID) * 2 for _ in range(3)]
                        if lr else None)
        self._sgr_ref = ([list(S.SGR_XQD_MID) for _ in range(3)]
                         if lr else None)
        self.warp8 = None

    def _write_lr(self, r4: int, c4: int) -> None:
        """spec read_lr mirror: for each plane, code RUs whose index
        range starts in this SB (WIENER or SGRPROJ frame type)."""
        if self.lr is None:
            return
        r4 += self.lr_off[0]
        c4 += self.lr_off[1]
        fmr, fmc = self.frame_mi
        for p in range(3):
            pl = self.lr[p]
            if pl is None:
                continue
            ss = 0 if p == 0 else 1
            unit = pl["unit"]
            use = pl["use"]
            sgr = pl.get("type", 2) == 3
            py0 = (r4 * 4) >> ss
            py1 = min((r4 + SB_MI) * 4, fmr * 4) >> ss
            px0 = (c4 * 4) >> ss
            px1 = min((c4 + SB_MI) * 4, fmc * 4) >> ss
            nr, nc = use.shape
            for ur in range(-(-py0 // unit), min(nr, -(-py1 // unit))):
                for uc in range(-(-px0 // unit), min(nc, -(-px1 // unit))):
                    on = int(use[ur, uc])
                    if sgr:
                        S._code_bin(self.enc, None, self.fc.sgrproj_restore,
                                    on)
                        if on:
                            ep = int(pl["ep"][ur, uc])
                            xqd = tuple(int(x) for x in pl["xqd"][ur, uc])
                            _, out = S.code_sgr_filter(self.enc, None,
                                                       self._sgr_ref[p],
                                                       ep, xqd)
                            self._sgr_ref[p] = list(out)
                        continue
                    S._code_bin(self.enc, None, self.fc.wiener_restore, on)
                    if on:
                        t = tuple(int(x) for x in pl["taps"][ur, uc])
                        # coded order: vertical then horizontal taps
                        S.code_wiener_filter(self.enc, None,
                                             self._lr_ref[p],
                                             t[3:] + t[:3])
                        self._lr_ref[p] = list(t[3:] + t[:3])

    def encode(self, modes: np.ndarray, levels_y: np.ndarray,
               levels_u: np.ndarray, levels_v: np.ndarray,
               cdef_idx=None, angles=None, uv_modes=None,
               cfl=None, sizes=None, levels16=None, ibc=None) -> bytes:
        """sizes: optional [nbh, nbw] per-8px-cell leaf size (8/16) from
        the multi-size wavefront; levels16: (ly, lu, lv) 16-leaf grids.
        Maps (modes/angles/uv/cfl) are per-cell, replicated across a
        16 leaf's four cells.  ibc: (use8 [nbh,nbw] bool, dv [nbh,nbw,2]
        int32 pixel offsets) for an allow_intrabc frame — every block
        then codes use_intrabc, and flagged blocks code a DV instead of
        mode info (spec intra block copy; ref write_intrabc_info,
        EbEntropyCoding.c:4827)."""
        tc = self.tc
        self.data = (modes, levels_y, levels_u, levels_v)
        self.angles = angles        # per-block angle delta (None = 0)
        self.uv_modes = uv_modes    # per-block chroma mode (None = DC)
        self.cfl = cfl              # [nbh,nbw,2] alphaQ3 (u, v); CFL blocks
        self.sizes = sizes
        self.levels16 = levels16
        self.ibc = ibc
        if ibc is not None:
            self.mi = MVP.MiInter(tc.mi_rows, tc.mi_cols)
        self.inter = False
        self.cdef_idx = cdef_idx
        for r4 in range(0, tc.mi_rows, SB_MI):
            for c4 in range(0, tc.mi_cols, SB_MI):
                self._cdef_done = False
                self._write_lr(r4, c4)
                self._partition(r4, c4, SB_MI)
        return self.enc.done()

    def encode_inter(self, sizes: np.ndarray, mvs: np.ndarray,
                     levels: dict, cdef_idx=None, refs=None,
                     sign_bias=None, comp_pair=None, mvs2=None,
                     txty=None, gm=None, shapes=None,
                     warp8=None, qmap=None, delta_q_res: int = 0) -> bytes:
        """P/B-frame tile: variable-partition single-ref NEWMV blocks.

        sizes:  [nb8h, nb8w] leaf size (8/16/32/64) covering each 8x8
                cell (for rect leaves: the NODE size)
        shapes: [nb8h, nb8w] leaf shape (0 square, 1 PARTITION_HORZ,
                2 PARTITION_VERT) or None (square-only)
        mvs:    [nb8h, nb8w, 2] selected leaf MV in 1/8-pel (quarter-pel
                granularity; even values; allow_high_precision_mv=0)
        levels: {bs: (ly, lu, lv)} per-size level grids; rect leaves
                under {(bh, bw): ...} keys
        refs:   [nb8h, nb8w] per-cell ref frame type (1=LAST..7=ALTREF);
                None = all LAST (flat low-delay P)
        Mirrors the reference inter write_modes_b path
        (EbEntropyCoding.c:5000-5290)."""
        tc = self.tc
        self.sizes = sizes
        self.shapes = shapes
        self.mvs = mvs
        self.levels = levels
        self.refs = refs
        self.sign_bias = sign_bias or (0,) * 8
        # compound: refs cell value COMP_CELL marks a compound block
        # using the frame-level BIDIR pair comp_pair with second MV mvs2
        self.comp_pair = comp_pair
        self.mvs2 = mvs2
        self.txty = txty      # per-cell luma tx type (0/9); None = DCT
        # global motion: {ref_type: (row8, col8)} TRANSLATION per ref
        # (spec 5.9.24; blocks whose MV equals it code GLOBALMV)
        self.gm = gm or {}
        # warped motion: warp8 = per-8x8-cell motion_mode map (0 SIMPLE /
        # 2 WARPED_CAUSAL), not-None only when the frame header signals
        # is_motion_mode_switchable + allow_warped_motion (spec
        # read_motion_mode; params are decoder-derived, never coded)
        self.warp8 = warp8
        self.ref_select = comp_pair is not None
        self.inter = True
        self.cdef_idx = cdef_idx
        # per-superblock delta-q (spec read_delta_qindex): qmap holds
        # each SB's ABSOLUTE target qindex (base + AQ offset, already on
        # the delta_q_res grid); the running CurrentQIndex mirrors the
        # decoder's state machine
        self.qmap = qmap
        self.dq_res = delta_q_res
        self._cur_q = self.qindex
        self.mi = MVP.MiInter(tc.mi_rows, tc.mi_cols)
        for r4 in range(0, tc.mi_rows, SB_MI):
            for c4 in range(0, tc.mi_cols, SB_MI):
                self._cdef_done = False
                self._dq_done = False
                self._write_lr(r4, c4)
                self._partition(r4, c4, SB_MI)
        return self.enc.done()

    def _write_delta_q(self, r4: int, c4: int, w4: int, h4: int,
                       skip: int) -> None:
        """spec read_delta_qindex: at each SB's first block, after the
        cdef index; an SB-sized skip block codes nothing."""
        if getattr(self, "qmap", None) is None or self._dq_done:
            return
        if (r4 % SB_MI) or (c4 % SB_MI):
            return
        self._dq_done = True
        if w4 == SB_MI and h4 == SB_MI and skip:
            return
        target = int(self.qmap[r4 // SB_MI, c4 // SB_MI])
        assert (target - self._cur_q) % (1 << self.dq_res) == 0, \
            "qmap target not on the delta_q_res grid (coded q would " \
            "diverge from the quantization q)"
        delta = (target - self._cur_q) >> self.dq_res
        S.code_delta_q(self.enc, None, self.fc, delta)
        # mirror the decoder's Clip3(1, 255, ...) on CurrentQIndex
        self._cur_q = int(np.clip(self._cur_q + (delta << self.dq_res),
                                  1, 255))

    def _write_cdef(self, r4: int, c4: int, skip: int) -> None:
        """ref write_cdef (EbEntropyCoding.c): emit the 64x64 unit's
        strength index as raw literal bits at the first non-skip block."""
        if self.cdef_idx is None or self._cdef_done or skip:
            return
        idx = int(self.cdef_idx[r4 // SB_MI, c4 // SB_MI])
        for b in range(self.cdef_bits - 1, -1, -1):
            self.enc.encode_bool((idx >> b) & 1, 16384)
        self._cdef_done = True

    def _leaf_here(self, r4: int, c4: int, n4: int) -> bool:
        if self.sizes is None:
            return False
        return int(self.sizes[r4 // 2, c4 // 2]) == n4 * 4

    def _partition(self, r4: int, c4: int, n4: int) -> None:
        tc = self.tc
        if r4 >= tc.mi_rows or c4 >= tc.mi_cols:
            return
        p = None
        if n4 == LEAF_MI:
            p = S.PARTITION_NONE
        elif self._leaf_here(r4, c4, n4):
            shp = (0 if not self.inter
                   or getattr(self, "shapes", None) is None
                   else int(self.shapes[r4 // 2, c4 // 2]))
            p = (S.PARTITION_NONE, S.PARTITION_HORZ,
                 S.PARTITION_VERT)[shp]
        if p is not None:
            write_partition_symbol(self.enc, self.fc, tc, r4, c4, n4, p)
            half = n4 >> 1
            if p == S.PARTITION_NONE:
                if self.inter:
                    self._inter_block(r4, c4, n4, n4)
                else:
                    self._block(r4, c4, n4 * 4)
            elif p == S.PARTITION_HORZ:
                self._inter_block(r4, c4, n4, half)
                self._inter_block(r4 + half, c4, n4, half)
            else:
                self._inter_block(r4, c4, half, n4)
                self._inter_block(r4, c4 + half, half, n4)
            return
        write_partition_symbol(self.enc, self.fc, tc, r4, c4, n4,
                               S.PARTITION_SPLIT)
        half = n4 >> 1
        self._partition(r4, c4, half)
        self._partition(r4, c4 + half, half)
        self._partition(r4 + half, c4, half)
        self._partition(r4 + half, c4 + half, half)

    _TX_OF = {8: T.TX_8X8, 16: T.TX_16X16, 32: T.TX_32X32, 64: T.TX_64X64}
    _TX_OF_C = {8: T.TX_4X4, 16: T.TX_8X8, 32: T.TX_16X16, 64: T.TX_32X32}
    # rect leaf transforms keyed (bh, bw) in pixels
    _TX_RECT = {(8, 16): T.TX_16X8, (16, 8): T.TX_8X16,
                (16, 32): T.TX_32X16, (32, 16): T.TX_16X32}
    _TX_RECT_C = {(8, 16): T.TX_8X4, (16, 8): T.TX_4X8,
                  (16, 32): T.TX_16X8, (32, 16): T.TX_8X16}

    def _inter_block(self, r4: int, c4: int, w4: int, h4: int) -> None:
        enc, fc, tc, mi = self.enc, self.fc, self.tc, self.mi
        bw, bh = w4 * 4, h4 * 4
        br, bc = r4 * 4 // bh, c4 * 4 // bw
        if w4 == h4:
            ly, lu, lv = self.levels[bw]
            tx_y, tx_c = self._TX_OF[bw], self._TX_OF_C[bw]
        else:
            ly, lu, lv = self.levels[(bh, bw)]
            tx_y = self._TX_RECT[(bh, bw)]
            tx_c = self._TX_RECT_C[(bh, bw)]
        lvls = (ly[br, bc], lu[br, bc], lv[br, bc])
        skip = int(all((l == 0).all() for l in lvls))
        mv8 = (int(self.mvs[r4 // 2, c4 // 2, 0]),
               int(self.mvs[r4 // 2, c4 // 2, 1]))
        assert mv8[0] % 2 == 0 and mv8[1] % 2 == 0, \
            "MVs must be quarter-pel (allow_high_precision_mv=0)"

        # skip coeff flag (skip_mode never allowed: no order hints)
        ctx = tc.skip_ctx(r4, c4)
        cdf = fc.skip[ctx]
        enc.encode_symbol(skip, cdf, 2)
        update_icdf(cdf, skip, 2)
        self._write_cdef(r4, c4, skip)
        self._write_delta_q(r4, c4, w4, h4, skip)

        # is_inter + ref frame(s)
        ref = (MVP.LAST_FRAME if self.refs is None
               else int(self.refs[r4 // 2, c4 // 2]))
        is_comp = self.ref_select and ref == 0
        S.code_is_inter(enc, None, fc, mi, tc, r4, c4, True)
        if self.ref_select:
            S.code_comp_inter(enc, None, fc, mi, tc, r4, c4, int(is_comp))
        counts = S.neighbor_ref_counts(mi, tc, r4, c4)
        if is_comp:
            rf = self.comp_pair
            S.code_comp_refs(enc, None, fc, mi, tc, counts, r4, c4, rf)
            res = MVP.find_mv_stack_comp(mi, r4, c4, w4, h4, rf,
                                         sign_bias=self.sign_bias)
            mv8b = (int(self.mvs2[r4 // 2, c4 // 2, 0]),
                    int(self.mvs2[r4 // 2, c4 // 2, 1]))
            pmv0 = MVP.lower_mv_precision(res.stack[0][0][0])
            pmv1 = MVP.lower_mv_precision(res.stack[0][0][1])
            if (mv8, mv8b) == (pmv0, pmv1):
                mode = S.NEAREST_NEARESTMV
                S.code_compound_mode(enc, None, fc, res, mode)
            else:
                mode = S.NEW_NEWMV
                S.code_compound_mode(enc, None, fc, res, mode)
                S.code_drl_idx(enc, None, fc, res, mode, 0)
                S.code_mv(enc, None, fc, pmv0, mv8)
                S.code_mv(enc, None, fc, pmv1, mv8b)
            tc.set_block(r4, c4, w4, h4, S.block_size_of(w4, h4),
                         S.DC_PRED, skip)
            mi.set_block(r4, c4, w4, h4, is_inter=True, ref_frame=rf[0],
                         ref_frame2=rf[1], mode=mode, mv=mv8, mv2=mv8b)
        else:
            S.code_single_ref(enc, None, fc, counts, ref)

            # mode + drl + MV (predictor from the shared ref-MV stack);
            # NEARESTMV when the MV equals the top stack entry and
            # GLOBALMV when it equals the frame's global translation
            # (both skip MV coding; ref write_modes_b mode selection)
            gmv = self.gm.get(ref, (0, 0))
            res = MVP.find_mv_stack(mi, r4, c4, w4, h4, ref,
                                    sign_bias=self.sign_bias,
                                    global_mv=gmv)
            pred_mv = MVP.lower_mv_precision(res.stack[0][0])
            if mv8 == pred_mv:
                mode = S.NEARESTMV
                S.code_inter_mode(enc, None, fc, res, mode)
            elif ref in self.gm and mv8 == gmv:
                mode = S.GLOBALMV
                S.code_inter_mode(enc, None, fc, res, mode)
            elif (res.num_mv_found >= 2
                  and mv8 == MVP.lower_mv_precision(res.stack[1][0])):
                mode = S.NEARMV
                S.code_inter_mode(enc, None, fc, res, mode)
                S.code_drl_idx(enc, None, fc, res, mode, 0)
            else:
                mode = S.NEWMV
                S.code_inter_mode(enc, None, fc, res, mode)
                S.code_drl_idx(enc, None, fc, res, mode, 0)
                S.code_mv(enc, None, fc, pred_mv, mv8)

            if self.warp8 is not None:
                raise NotImplementedError("warped motion is not ported")

            tc.set_block(r4, c4, w4, h4, S.block_size_of(w4, h4),
                         S.DC_PRED, skip)
            mi.set_block(r4, c4, w4, h4, is_inter=True,
                         ref_frame=ref, mode=mode, mv=mv8)

        # luma tx type (reduced inter set: DCT / IDTX); chroma inherits
        # it for the INVERSE transform (spec compute_tx_type) but its
        # coefficient syntax always parses with class-2D contexts
        ttx = 0 if self.txty is None else int(self.txty[r4 // 2, c4 // 2])
        for plane, (lvl, tx_size) in enumerate(zip(lvls, (tx_y, tx_c,
                                                          tx_c))):
            pr = r4 >> (plane > 0)
            pc = c4 >> (plane > 0)
            w4p = w4 >> (plane > 0)
            h4p = h4 >> (plane > 0)
            if skip:
                self.tc.set_txb(plane, pr, pc, w4p, h4p, 0)
                continue
            txb_ctx, dc_ctx = tc.txb_ctx(plane, pr, pc, w4p, h4p,
                                         full_block_tx=True,
                                         larger_block=False)
            # dim-64 transforms code only the adjusted 32x32 region
            # (spec Adjusted_Tx_Size; the device zeroes the rest)
            aw, ah = S.adjusted_dims(tx_size)
            cul = S.write_coeffs_txb(
                enc, fc, lvl[:ah, :aw], tx_size, int(plane > 0),
                ttx if plane == 0 else 0, txb_ctx, dc_ctx,
                write_tx_type=True, reduced_tx_set=self.reduced_tx_set,
                allow_tx_type=self.qindex > 0, is_inter=True)
            tc.set_txb(plane, pr, pc, w4p, h4p, cul)

    def _block(self, r4: int, c4: int, bs: int = 8) -> None:
        modes, ly, lu, lv = self.data
        enc, fc, tc = self.enc, self.fc, self.tc
        br, bc = r4 // LEAF_MI, c4 // LEAF_MI
        n4 = bs // 4
        y_mode = int(modes[br, bc])
        if bs == 8:
            lvls = (ly[br, bc], lu[br, bc], lv[br, bc])
        else:
            l16y, l16u, l16v = self.levels16
            lvls = (l16y[br // 2, bc // 2], l16u[br // 2, bc // 2],
                    l16v[br // 2, bc // 2])
        skip = int(all((l == 0).all() for l in lvls))

        # skip flag
        ctx = tc.skip_ctx(r4, c4)
        cdf = fc.skip[ctx]
        enc.encode_symbol(skip, cdf, 2)
        update_icdf(cdf, skip, 2)
        self._write_cdef(r4, c4, skip)

        if getattr(self, "ibc", None) is not None:
            # use_intrabc + DV (spec intra block copy; ref
            # write_intrabc_info EbEntropyCoding.c:4827) — flagged
            # blocks code a DV against the INTRA_FRAME stack predictor
            # and skip all intra mode syntax; YMode counts as DC_PRED
            # for neighbor contexts
            use8, dv8 = self.ibc
            use = int(use8[br, bc])
            cdf = fc.intrabc
            enc.encode_symbol(use, cdf, 2)
            update_icdf(cdf, use, 2)
            if use:
                mv8 = (int(dv8[br, bc, 0]) * 8, int(dv8[br, bc, 1]) * 8)
                dv_ref = MVP.dv_ref_for_block(self.mi, r4, c4, n4, n4)
                S.code_mv(enc, None, fc.dv, dv_ref, mv8,
                          force_integer=True)
                tc.set_block(r4, c4, n4, n4, S.block_size_of(n4, n4),
                             S.DC_PRED, skip)
                self.mi.set_block(r4, c4, n4, n4, is_inter=True,
                                  ref_frame=MVP.INTRA_FRAME, mode=0,
                                  mv=mv8)
                # residuals: intra-bc blocks parse with the INTER tx-set
                # semantics (spec: is_inter_block includes use_intrabc)
                for plane, (lvl, tx_size) in enumerate(
                        zip(lvls, (self._TX_OF[bs], self._TX_OF_C[bs],
                                   self._TX_OF_C[bs]))):
                    pr = r4 >> (plane > 0)
                    pc = c4 >> (plane > 0)
                    w4 = n4 >> (plane > 0)
                    if skip:
                        self.tc.set_txb(plane, pr, pc, w4, w4, 0)
                        continue
                    txb_ctx, dc_ctx = tc.txb_ctx(plane, pr, pc, w4, w4,
                                                 full_block_tx=True,
                                                 larger_block=False)
                    cul = S.write_coeffs_txb(
                        enc, fc, lvl, tx_size, int(plane > 0), 0,
                        txb_ctx, dc_ctx, write_tx_type=True,
                        reduced_tx_set=self.reduced_tx_set,
                        allow_tx_type=self.qindex > 0, is_inter=True)
                    tc.set_txb(plane, pr, pc, w4, w4, cul)
                return

        # y mode (keyframe cdf)
        actx, lctx = tc.kf_y_ctx(r4, c4)
        cdf = fc.kf_y_mode[actx][lctx]
        enc.encode_symbol(y_mode, cdf, 13)
        update_icdf(cdf, y_mode, 13)
        if S.V_PRED <= y_mode <= S.D67_PRED:  # directional: angle delta
            delta = 0 if self.angles is None else int(self.angles[br, bc])
            cdf = fc.angle_delta[y_mode - S.V_PRED]
            enc.encode_symbol(delta + S.MAX_ANGLE_DELTA, cdf, 7)
            update_icdf(cdf, delta + S.MAX_ANGLE_DELTA, 7)

        # uv mode (cfl-allowed context at 8x8)
        uv = (S.DC_PRED if self.uv_modes is None
              else int(self.uv_modes[br, bc]))
        cdf = fc.uv_mode[1][y_mode]
        enc.encode_symbol(uv, cdf, 14)
        update_icdf(cdf, uv, 14)
        if uv == S.UV_CFL_PRED:
            au = int(self.cfl[br, bc, 0])
            av = int(self.cfl[br, bc, 1])
            S.code_cfl_alphas(enc, None, fc, au, av)
        if S.V_PRED <= uv <= S.D67_PRED:   # angle_delta_uv (always 0)
            cdf = fc.angle_delta[uv - S.V_PRED]
            enc.encode_symbol(S.MAX_ANGLE_DELTA, cdf, 7)
            update_icdf(cdf, S.MAX_ANGLE_DELTA, 7)

        tc.set_block(r4, c4, n4, n4, S.block_size_of(n4, n4), y_mode,
                     skip)

        # residuals
        for plane, (lvl, tx_size) in enumerate(
                zip(lvls, (self._TX_OF[bs], self._TX_OF_C[bs],
                           self._TX_OF_C[bs]))):
            pr = r4 >> (plane > 0)
            pc = c4 >> (plane > 0)
            w4 = n4 >> (plane > 0)
            if skip:
                self.tc.set_txb(plane, pr, pc, w4, w4, 0)
                continue
            txb_ctx, dc_ctx = tc.txb_ctx(plane, pr, pc, w4, w4,
                                         full_block_tx=True,
                                         larger_block=False)
            cul = S.write_coeffs_txb(
                enc, fc, lvl, tx_size, int(plane > 0), 0, txb_ctx, dc_ctx,
                write_tx_type=True, y_mode=y_mode,
                reduced_tx_set=self.reduced_tx_set,
                allow_tx_type=self.qindex > 0)
            tc.set_txb(plane, pr, pc, w4, w4, cul)
