"""AV1 reference-MV stack derivation (single-reference path).

Behavioral parity with the reference's setup_ref_mv_list
(EbAdaptiveMotionVectorPrediction.c:631) restricted to what this build
codes: single reference frame, no temporal MVs (use_ref_frame_mvs=0, no
order hints), identity global motion.  ONE implementation is shared by
the encoder's tile writer and the mirror decoder, so predictor/context
derivation cannot diverge.

Grid-of-mi-units state (the reference's mi array of ModeInfo pointers)
is held in ``MiInter``; every field is replicated per 4x4 cell exactly
like the reference's mi grid, so mid-block reads during scans behave
identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MVREF_ROW_COLS = 3
REF_CAT_LEVEL = 640
MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
MV_BORDER = 16 * 8
NONE_FRAME, INTRA_FRAME, LAST_FRAME = -1, 0, 1

# inter modes (AV1 enum order; ref EbDefinitions.h PredictionMode)
NEARESTMV, NEARMV, GLOBALMV, NEWMV = 13, 14, 15, 16
NEAREST_NEARESTMV, NEAR_NEARMV = 17, 18
NEAREST_NEWMV, NEW_NEARESTMV, NEAR_NEWMV, NEW_NEARMV = 19, 20, 21, 22
GLOBAL_GLOBALMV, NEW_NEWMV = 23, 24

# modes that code a NEWMV component (ref have_newmv_in_inter_mode)
_NEWMV_MODES = {NEWMV, NEW_NEWMV, NEAREST_NEWMV, NEW_NEARESTMV,
                NEAR_NEWMV, NEW_NEARMV}


@dataclass
class MiInter:
    """Per-mi inter-coding state for one tile (mirrors the mi grid)."""
    mi_rows: int
    mi_cols: int
    is_inter: np.ndarray = field(init=False)
    ref_frame: np.ndarray = field(init=False)   # 0 = intra
    ref_frame2: np.ndarray = field(init=False)  # -1 = single-ref
    mode: np.ndarray = field(init=False)        # pred mode enum
    mv: np.ndarray = field(init=False)          # [mr, mc, 2] (row, col) 1/8pel
    mv2: np.ndarray = field(init=False)         # compound second MV
    w4: np.ndarray = field(init=False)          # block width in mi units
    h4: np.ndarray = field(init=False)

    def __post_init__(self):
        mr, mc = self.mi_rows, self.mi_cols
        self.is_inter = np.zeros((mr, mc), np.bool_)
        self.ref_frame = np.zeros((mr, mc), np.int8)
        self.ref_frame2 = np.full((mr, mc), NONE_FRAME, np.int8)
        self.mode = np.zeros((mr, mc), np.uint8)
        self.mv = np.zeros((mr, mc, 2), np.int16)
        self.mv2 = np.zeros((mr, mc, 2), np.int16)
        self.w4 = np.zeros((mr, mc), np.uint8)
        self.h4 = np.zeros((mr, mc), np.uint8)

    def set_block(self, r: int, c: int, w4: int, h4: int, *, is_inter: bool,
                  ref_frame: int, mode: int, mv=(0, 0),
                  ref_frame2: int = NONE_FRAME, mv2=(0, 0)) -> None:
        sl = np.s_[r : r + h4, c : c + w4]
        self.is_inter[sl] = is_inter
        self.ref_frame[sl] = ref_frame
        self.ref_frame2[sl] = ref_frame2
        self.mode[sl] = mode
        self.mv[sl] = mv
        self.mv2[sl] = mv2
        self.w4[sl] = w4
        self.h4[sl] = h4

    def cand_refs(self, r: int, c: int):
        """(ref, mv) pairs of the candidate's used reference slots."""
        out = [(int(self.ref_frame[r, c]),
                (int(self.mv[r, c, 0]), int(self.mv[r, c, 1])))]
        r2 = int(self.ref_frame2[r, c])
        if r2 > INTRA_FRAME:
            out.append((r2, (int(self.mv2[r, c, 0]),
                             int(self.mv2[r, c, 1]))))
        return out


def _has_top_right(sb_mi: int, mi_row: int, mi_col: int, w4: int, h4: int,
                   bs: int) -> int:
    """ref has_top_right (EbAdaptiveMotionVectorPrediction.c:562),
    incl. the rectangular-block rules: the FIRST (left) half of a VERT
    partition always has a top-right (the block above is decoded); the
    SECOND (bottom) half of a HORZ partition never does.  is_sec_rect
    marks the second rect block (no AB/4-way shapes produced here)."""
    if bs > 16:  # mi_size_wide[BLOCK_64X64]
        return 0
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = 0
                break
        else:
            break
        b <<= 1
    is_sec_rect = 0
    if w4 < h4 and (mi_col & (h4 - 1)):
        is_sec_rect = 1
    if w4 > h4 and (mi_row & (w4 - 1)):
        is_sec_rect = 1
    if w4 < h4 and not is_sec_rect:
        has_tr = 1
    if w4 > h4 and is_sec_rect:
        has_tr = 0
    return int(has_tr)


class MvStackResult:
    __slots__ = ("stack", "num_mv_found", "num_nearest", "mode_context",
                 "global_mv")

    def __init__(self, stack, num_mv_found, num_nearest, mode_context,
                 global_mv):
        self.stack = stack                    # [(mv(row,col), weight)] padded >=2
        self.num_mv_found = num_mv_found      # real count (drl gating)
        self.num_nearest = num_nearest
        self.mode_context = mode_context
        self.global_mv = global_mv

    # --- entropy-coding context accessors (ref Av1ModeContextAnalyzer) ----
    @property
    def newmv_ctx(self) -> int:
        return self.mode_context & 7

    @property
    def zeromv_ctx(self) -> int:
        return (self.mode_context >> 3) & 1

    @property
    def refmv_ctx(self) -> int:
        return (self.mode_context >> 4) & 15

    def drl_ctx(self, idx: int) -> int:
        """ref av1_drl_ctx (EbRateDistortionCost.c:43)."""
        w0 = self.stack[idx][1]
        w1 = self.stack[idx + 1][1]
        if w0 >= REF_CAT_LEVEL and w1 >= REF_CAT_LEVEL:
            return 0
        if w0 >= REF_CAT_LEVEL and w1 < REF_CAT_LEVEL:
            return 1
        if w0 < REF_CAT_LEVEL and w1 < REF_CAT_LEVEL:
            return 2
        return 0


def find_mv_stack(mi: MiInter, mi_row: int, mi_col: int, w4: int, h4: int,
                  ref_frame: int = LAST_FRAME, sb_mi: int = 16,
                  sign_bias=None, global_mv=(0, 0)) -> MvStackResult:
    """Single-ref ref-MV stack + mode context (ref setup_ref_mv_list).
    sign_bias[ref 0..7]: 1 for backward refs (order hint > current) —
    drives MV sign flips in the relaxed extension scans.  global_mv is
    the frame's TRANSLATION global motion for ref_frame in 1/8-pel
    (spec setup_global_mv; pads the stack and backs GLOBALMV)."""
    return _find_stack(mi, mi_row, mi_col, w4, h4, (ref_frame,), sb_mi,
                       sign_bias or (0,) * 8, global_mv)


def find_mv_stack_comp(mi: MiInter, mi_row: int, mi_col: int, w4: int,
                       h4: int, rf=(1, 7), sb_mi: int = 16,
                       sign_bias=None) -> MvStackResult:
    """Compound ref-MV stack for the ref pair rf (ref setup_ref_mv_list
    compound path).  Stack entries are ((mv0, mv1), weight)."""
    return _find_stack(mi, mi_row, mi_col, w4, h4, tuple(rf), sb_mi,
                       sign_bias or (0,) * 8, (0, 0))


def _find_stack(mi: MiInter, mi_row: int, mi_col: int, w4: int, h4: int,
                rf: tuple, sb_mi: int, sign_bias,
                global_mv=(0, 0)) -> MvStackResult:
    is_comp = len(rf) == 2
    ref_frame = rf[0]

    stack: list[list] = []  # [mv | (mv0, mv1), weight]
    newmv_count = 0
    row_match = 0
    col_match = 0

    def add_candidate(r: int, c: int, length: int, weight: int,
                      count_newmv: bool) -> bool:
        """Returns True if the candidate references rf (ref
        add_ref_mv_candidate)."""
        nonlocal newmv_count
        if not mi.is_inter[r, c]:
            return False
        matched = False
        if not is_comp:
            # single path: either slot of the neighbor may match
            for cref, cmv in mi.cand_refs(r, c):
                if cref != ref_frame:
                    continue
                matched = True
                for ent in stack:
                    if ent[0] == cmv:
                        ent[1] += weight * length
                        break
                else:
                    if len(stack) < MAX_REF_MV_STACK_SIZE:
                        stack.append([cmv, weight * length])
                if count_newmv and int(mi.mode[r, c]) in _NEWMV_MODES:
                    newmv_count += 1
        else:
            if (int(mi.ref_frame[r, c]) == rf[0]
                    and int(mi.ref_frame2[r, c]) == rf[1]):
                matched = True
                pair = ((int(mi.mv[r, c, 0]), int(mi.mv[r, c, 1])),
                        (int(mi.mv2[r, c, 0]), int(mi.mv2[r, c, 1])))
                for ent in stack:
                    if ent[0] == pair:
                        ent[1] += weight * length
                        break
                else:
                    if len(stack) < MAX_REF_MV_STACK_SIZE:
                        stack.append([pair, weight * length])
                if count_newmv and int(mi.mode[r, c]) in _NEWMV_MODES:
                    newmv_count += 1
        return matched

    row_adj = (h4 < 2) and (mi_row & 1)
    col_adj = (w4 < 2) and (mi_col & 1)
    max_row_offset = 0
    max_col_offset = 0
    if mi_row > 0:
        max_row_offset = -(MVREF_ROW_COLS << 1) + int(row_adj)
        if h4 < 2:
            max_row_offset = -(2 << 1) + int(row_adj)
        max_row_offset = max(max_row_offset, -mi_row)
    if mi_col > 0:
        max_col_offset = -(MVREF_ROW_COLS << 1) + int(col_adj)
        if w4 < 2:
            max_col_offset = -(2 << 1) + int(col_adj)
        max_col_offset = max(max_col_offset, -mi_col)

    processed_rows = 0
    processed_cols = 0

    def scan_row(row_offset: int, count_newmv: bool) -> None:
        nonlocal processed_rows, row_match
        end_mi = min(w4, mi.mi_cols - mi_col, 16)
        col_off = 0
        if abs(row_offset) > 1:
            col_off = 1
            if (mi_col & 1) and w4 < 2:
                col_off -= 1
        use_step_16 = w4 >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_offset
            c = mi_col + col_off + i
            if c >= mi.mi_cols:   # spec scan_row is_inside guard
                break
            cw4 = max(1, int(mi.w4[r, c]))
            length = min(w4, cw4)
            if use_step_16:
                length = max(4, length)
            elif abs(row_offset) > 1:
                length = max(2, length)
            weight = 2
            if 2 <= w4 <= cw4:
                inc = min(-max_row_offset + row_offset + 1,
                          max(1, int(mi.h4[r, c])))
                weight = max(weight, inc)
                processed_rows = inc - row_offset - 1
            if add_candidate(r, c, length, weight, count_newmv):
                row_match += 1
            i += length

    def scan_col(col_offset: int, count_newmv: bool) -> None:
        nonlocal processed_cols, col_match
        end_mi = min(h4, mi.mi_rows - mi_row, 16)
        row_off = 0
        if abs(col_offset) > 1:
            row_off = 1
            if (mi_row & 1) and h4 < 2:
                row_off -= 1
        use_step_16 = h4 >= 16
        i = 0
        while i < end_mi:
            r = mi_row + row_off + i
            c = mi_col + col_offset
            if r >= mi.mi_rows:   # spec scan_col is_inside guard
                break
            ch4 = max(1, int(mi.h4[r, c]))
            length = min(h4, ch4)
            if use_step_16:
                length = max(4, length)
            elif abs(col_offset) > 1:
                length = max(2, length)
            weight = 2
            if 2 <= h4 <= ch4:
                inc = min(-max_col_offset + col_offset + 1,
                          max(1, int(mi.w4[r, c])))
                weight = max(weight, inc)
                processed_cols = inc - col_offset - 1
            if add_candidate(r, c, length, weight, count_newmv):
                col_match += 1
            i += length

    def scan_point(row_offset: int, col_offset: int, count_newmv: bool,
                   to_row: bool) -> None:
        nonlocal row_match, col_match
        r = mi_row + row_offset
        c = mi_col + col_offset
        if 0 <= r < mi.mi_rows and 0 <= c < mi.mi_cols:
            if add_candidate(r, c, 2, 2, count_newmv):
                if to_row:
                    row_match += 1
                else:
                    col_match += 1

    # --- nearest row/col + top-right ---------------------------------------
    if abs(max_row_offset) >= 1:
        scan_row(-1, True)
    if abs(max_col_offset) >= 1:
        scan_col(-1, True)
    if _has_top_right(sb_mi, mi_row, mi_col, w4, h4, max(w4, h4)):
        scan_point(-1, w4, True, to_row=True)

    nearest_match = int(row_match > 0) + int(col_match > 0)
    num_nearest = len(stack)
    for ent in stack:
        ent[1] += REF_CAT_LEVEL

    # --- outer area: top-left point, rows/cols -3, -5 ----------------------
    scan_point(-1, -1, False, to_row=True)
    for idx in range(2, MVREF_ROW_COLS + 1):
        row_offset = -(idx << 1) + 1 + int(row_adj)
        col_offset = -(idx << 1) + 1 + int(col_adj)
        if abs(row_offset) <= abs(max_row_offset) and \
                abs(row_offset) > processed_rows:
            scan_row(row_offset, False)
        if abs(col_offset) <= abs(max_col_offset) and \
                abs(col_offset) > processed_cols:
            scan_col(col_offset, False)

    total_matches = int(row_match > 0) + int(col_match > 0)

    if nearest_match == 0:
        mode_context = min(total_matches, 1)
        if total_matches == 1:
            mode_context |= 1 << 4
        elif total_matches >= 2:
            mode_context |= 2 << 4
    elif nearest_match == 1:
        mode_context = 2 if newmv_count > 0 else 3
        if total_matches == 1:
            mode_context |= 3 << 4
        elif total_matches >= 2:
            mode_context |= 4 << 4
    else:
        mode_context = 4 if newmv_count >= 1 else 5
        mode_context |= 5 << 4

    # --- weight sort (stable bubble, two segments; ref :806-838) -----------
    def bubble(lo: int, hi: int) -> None:
        length = hi
        while length > lo:
            nr_len = lo
            for idx in range(lo + 1, length):
                if stack[idx - 1][1] < stack[idx][1]:
                    stack[idx - 1], stack[idx] = stack[idx], stack[idx - 1]
                    nr_len = idx
            length = nr_len

    bubble(0, num_nearest)
    bubble(num_nearest, len(stack))

    # --- extension scans (relaxed row/col -1; ref :848-1046) ---------------
    mi_w = min(16, w4, mi.mi_cols - mi_col)
    mi_h = min(16, h4, mi.mi_rows - mi_row)
    mi_size = min(mi_w, mi_h)

    def flip(mv, cref, target):
        if sign_bias[cref] != sign_bias[target]:
            return (-mv[0], -mv[1])
        return mv

    if not is_comp:
        if len(stack) < MAX_MV_REF_CANDIDATES:
            def relaxed(row_scan: bool) -> None:
                idx = 0
                while idx < mi_size and len(stack) < MAX_MV_REF_CANDIDATES:
                    if row_scan:
                        r, c = mi_row - 1, mi_col + idx
                        step = max(1, int(mi.w4[r, c]))
                    else:
                        r, c = mi_row + idx, mi_col - 1
                        step = max(1, int(mi.h4[r, c]))
                    if mi.is_inter[r, c]:
                        for cref, cmv in mi.cand_refs(r, c):
                            if cref <= INTRA_FRAME:
                                continue
                            this_mv = flip(cmv, cref, ref_frame)
                            if all(ent[0] != this_mv for ent in stack):
                                stack.append([this_mv, 2])
                    idx += step

            if abs(max_row_offset) >= 1:
                relaxed(True)
            if abs(max_col_offset) >= 1:
                relaxed(False)
    elif len(stack) < MAX_MV_REF_CANDIDATES:
        # compound extension (ref :845-955): collect exact-ref (ref_id)
        # and other-inter (ref_diff, sign-corrected) per pair side from
        # the immediate row/col, then synthesize combined candidates
        ref_id = [[], []]
        ref_diff = [[], []]

        def gather(row_scan: bool) -> None:
            idx = 0
            while idx < mi_size:
                if row_scan:
                    r, c = mi_row - 1, mi_col + idx
                    step = max(1, int(mi.w4[r, c]))
                else:
                    r, c = mi_row + idx, mi_col - 1
                    step = max(1, int(mi.h4[r, c]))
                if mi.is_inter[r, c]:
                    for cref, cmv in mi.cand_refs(r, c):
                        for side in range(2):
                            if cref == rf[side] and len(ref_id[side]) < 2:
                                ref_id[side].append(cmv)
                            elif (cref > INTRA_FRAME
                                  and len(ref_diff[side]) < 2):
                                ref_diff[side].append(
                                    flip(cmv, cref, rf[side]))
                idx += step

        if abs(max_row_offset) >= 1:
            gather(True)
        if abs(max_col_offset) >= 1:
            gather(False)

        comp_list = [[global_mv] * 2 for _ in range(3)]
        for side in range(2):
            ci = 0
            for mv_ in ref_id[side][:3]:
                comp_list[ci][side] = mv_
                ci += 1
            for mv_ in ref_diff[side]:
                if ci >= 3:
                    break
                comp_list[ci][side] = mv_
                ci += 1
        if stack:  # one real entry: append the first non-duplicate combo
            if (comp_list[0][0], comp_list[0][1]) == stack[0][0]:
                stack.append([(comp_list[1][0], comp_list[1][1]), 2])
            else:
                stack.append([(comp_list[0][0], comp_list[0][1]), 2])
        else:
            for idx in range(MAX_MV_REF_CANDIDATES):
                stack.append([(comp_list[idx][0], comp_list[idx][1]), 2])

    num_mv_found = len(stack)

    # --- clamp + pad to MAX_MV_REF_CANDIDATES with global mv ---------------
    bw8 = w4 * 4 * 8  # block dims in 1/8 pel
    bh8 = h4 * 4 * 8
    lo_row = -(mi_row * 32) - bh8 - MV_BORDER
    hi_row = (mi.mi_rows - h4 - mi_row) * 32 + bh8 + MV_BORDER
    lo_col = -(mi_col * 32) - bw8 - MV_BORDER
    hi_col = (mi.mi_cols - w4 - mi_col) * 32 + bw8 + MV_BORDER

    def clamp(mv):
        return (int(np.clip(mv[0], lo_row, hi_row)),
                int(np.clip(mv[1], lo_col, hi_col)))

    out = []
    for ent in stack:
        if is_comp:
            out.append(((clamp(ent[0][0]), clamp(ent[0][1])), ent[1]))
        else:
            out.append((clamp(ent[0]), ent[1]))
    while len(out) < MAX_MV_REF_CANDIDATES:
        out.append(((global_mv, global_mv) if is_comp else global_mv, 2))

    return MvStackResult(out, num_mv_found, num_nearest, mode_context,
                         global_mv)


def lower_mv_precision(mv, allow_hp: bool = False,
                       force_integer: bool = False):
    """ref lower_mv_precision semantics for predictors before MV coding."""
    row, col = int(mv[0]), int(mv[1])
    if force_integer:
        def snap(v: int) -> int:
            mod = v % 8 if v >= 0 else -((-v) % 8)
            if mod == 0:
                return v
            v -= mod
            if abs(mod) > 4:
                v += 8 if mod > 0 else -8
            return v
        row, col = snap(row), snap(col)
    elif not allow_hp:
        if row & 1:
            row += -1 if row > 0 else 1
        if col & 1:
            col += -1 if col > 0 else 1
    return (row, col)


# --- intra block copy DV prediction (screen content) -------------------------

def find_ref_dv(mi_row: int, mi_col: int, mib_size: int = 16,
                tile_row_start: int = 0) -> tuple:
    """Fallback DV predictor when the INTRA_FRAME stack is empty (spec
    intra-bc ref DV; ref av1_find_ref_dv,
    EbAdaptiveMotionVectorPrediction.c:2047): the superblock above, or
    one SB + the 256-px hardware delay to the left on the first SB row.
    Returns 1/8-pel (row, col)."""
    if mi_row - mib_size < tile_row_start:
        return (0, (-4 * mib_size - 256) * 8)
    return (-4 * mib_size * 8, 0)


def dv_ref_for_block(mi: MiInter, mi_row: int, mi_col: int, w4: int,
                     h4: int, mib_size: int = 16) -> tuple:
    """DV predictor for an intra-bc block: nearest/near from the
    INTRA_FRAME ref-MV stack (neighbors that used intra-bc), falling
    back to find_ref_dv when both are zero (ref EbModeDecision.c dv_ref
    selection: nearestmv if nonzero else nearmv else av1_find_ref_dv).
    Shared by the tile writer, the mirror decoder and the conformance
    checker — DVs are full-pel so precision lowering is a no-op."""
    res = find_mv_stack(mi, mi_row, mi_col, w4, h4, INTRA_FRAME,
                        sb_mi=mib_size)
    nearest = lower_mv_precision(res.stack[0][0])
    near = lower_mv_precision(res.stack[1][0])
    dv = nearest if nearest != (0, 0) else near
    if dv == (0, 0):
        dv = find_ref_dv(mi_row, mi_col, mib_size)
    return dv
