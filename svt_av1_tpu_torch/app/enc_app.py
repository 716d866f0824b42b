"""Encoder CLI of the port (counterpart of svt_av1_tpu.app.enc_app; ref
SvtAv1EncApp, EbAppMain.c:82 / EbAppConfig.c tokens).

The same flags as the reference package's CLI, and writes the same IVF,
recon and stat files, plus ``--device cuda|cpu`` (default ``cuda``;
without a card the app fails unless ``--device cpu`` is given — it
never falls back to the CPU) and ``--multi-ref -1|0|1`` (the config's
multi_ref: a third reference on hier-B interior frames; -1 follows the
preset):
  -i <file>       input (.y4m autodetected, else raw 4:2:0 YUV; '-' stdin)
  -b <file>       output IVF bitstream
  -o <file>       optional recon YUV output (ref -o)
  -w/-h           width/height (required for raw YUV)
  -q              quantizer 0..63 (ref -q)
  -n              number of frames to encode
  --preset        enc_mode 0..8 (ref -enc-mode)
  --intra-period  -2 intra-only, -1 first-frame-only, N = keyframe every N+1
  --pred-struct   0 low-delay P, 1 low-delay B, 2 random access (hier-B)
  --fps           frame rate (IVF header)
  --tiles-log2    tile columns log2
  --lookahead     look-ahead window (frames)
  --qp-file       per-frame QP overrides (push_qp)
  --stat-report   print per-frame PSNR
  --synthetic N   encode N synthetic frames (no input needed)

``--bit-depth 10`` (raw little-endian 16-bit samples, or
``--compressed-ten-bit 1``) writes 16-bit recon files, as the reference
CLI does.  ``--nch N`` encodes N same-geometry channels in lockstep
(MultiStreamEncoder: ``-i`` and ``-b`` take N comma-separated paths);
``--gop-shards G`` (with ``--pred-struct 0`` and ``--intra-period >=
1``) encodes G GOPs of the one stream in lockstep (GopShardedEncoder).
Settings the port does not run yet (``--scm``, warped motion, film
grain) exit non-zero with the refusal's text.

Run: python -m svt_av1_tpu_torch.app.enc_app -w 854 -h 480 -q 40 \\
         --synthetic 8 --intra-period -1 --pred-struct 1 -b out.ivf \\
         --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

# config-file tokens (ref Config/Sample.cfg key names) -> argparse dests
CFG_KEYS = {
    "InputFile": "input", "StreamFile": "output", "ReconFile": "recon",
    "SourceWidth": "width", "SourceHeight": "height", "QP": "qp",
    "FrameToBeEncoded": "frames", "EncoderMode": "preset",
    "IntraPeriod": "intra_period", "PredStructure": "pred_struct",
    "HierarchicalLevels": "hierarchical_levels", "FrameRate": "fps",
    "TileCol": "tiles_log2", "EncoderBitDepth": "bit_depth",
    "CompressedTenBitFormat": "packed10", "RateControlMode": "rc_mode",
    "TargetBitRate": "tbr", "LookAheadDistance": "lookahead",
    "UseQpFile": None, "QpFile": "qp_file",
}


def parse_config_file(path: str) -> dict:
    """ref config-file layer (EbAppConfig.c / Config/Sample.cfg): lines
    of 'Token : value'.  Returns {argparse dest: value}; the caller
    installs these as parser DEFAULTS so explicit CLI flags still win
    (the reference's precedence)."""
    out = {}
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#")[0].strip()
            if not line or ":" not in line:
                continue
            k, v = (t.strip() for t in line.split(":", 1))
            dest = CFG_KEYS.get(k)
            if dest is None:
                continue
            try:
                out[dest] = int(v)
            except ValueError:
                out[dest] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="svt_av1_tpu_torch.enc_app",
                                add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-c", dest="config_file",
                   help="config file (Sample.cfg token syntax)")
    p.add_argument("-i", dest="input")
    p.add_argument("-b", dest="output")
    p.add_argument("-o", dest="recon")
    p.add_argument("-w", dest="width", type=int, default=0)
    p.add_argument("-h", dest="height", type=int, default=0)
    p.add_argument("-q", dest="qp", type=int, default=50)
    p.add_argument("-n", dest="frames", type=int, default=0)
    p.add_argument("--preset", type=int, default=8)
    p.add_argument("--intra-period", type=int, default=-2)
    p.add_argument("--pred-struct", type=int, default=0,
                   help="0 low-delay P, 1 low-delay B, 2 random access "
                        "(hier-B)")
    p.add_argument("--hierarchical-levels", type=int, default=3)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--tiles-log2", type=int, default=0)
    p.add_argument("--stat-report", action="store_true")
    p.add_argument("--stat-file", dest="stat_file",
                   help="per-frame bits/PSNR log + summary (ref StatFile)")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--bit-depth", dest="bit_depth", type=int, default=8)
    p.add_argument("--compressed-ten-bit", dest="packed10", type=int,
                   default=0, help="raw input is SVT packed 10-bit")
    p.add_argument("--qp-file", dest="qp_file",
                   help="per-frame QP overrides, one per line (ref -qp-file)")
    p.add_argument("--rc", dest="rc_mode", type=int, default=0,
                   help="0 CQP, 2 VBR, 3 CVBR")
    p.add_argument("--tbr", dest="tbr", type=int, default=0,
                   help="target bitrate (bits/s) for VBR/CVBR")
    p.add_argument("--lookahead", dest="lookahead", type=int, default=0)
    p.add_argument("--nch", type=int, default=1,
                   help="channels: N lockstep streams batched per device "
                        "step (comma-separated -i / -b paths)")
    p.add_argument("--gop-shards", type=int, default=1,
                   help="GOPs of the stream encoded in lockstep (needs "
                        "--pred-struct 0 and --intra-period >= 1)")
    p.add_argument("--scm", dest="scm", type=int, default=0,
                   help="screen content mode: 0 off, 1 on, 2 auto "
                        "(not yet ported)")
    p.add_argument("--inj", dest="injector", type=float, default=0,
                   help="injector: pace input at N fps (live-input "
                        "simulation, ref EbInjector / "
                        "EbAppProcessCmd.c:987)")
    p.add_argument("--multi-ref", dest="multi_ref", type=int, default=-1,
                   choices=(-1, 0, 1),
                   help="third reference on hier-B interior frames: 1 on, "
                        "0 off, -1 on at presets <= 7")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the encoder runs (default cuda; no "
                        "fallback to the CPU)")
    return p


def open_reader(path, args):
    from svt_av1_tpu_torch.io import (Y4MReader, YuvReader, YuvReader10,
                                      YuvReaderPacked10)
    fh = sys.stdin.buffer if path == "-" else open(path, "rb")
    head = fh.peek(9)[:9] if hasattr(fh, "peek") else b""
    if path.endswith(".y4m") or head.startswith(b"YUV4MPEG2"):
        r = Y4MReader(fh)
        return r, r.w, r.h
    if not (args.width and args.height):
        raise SystemExit("raw YUV requires -w and -h")
    w, h = args.width, args.height
    if args.bit_depth == 10:
        r = (YuvReaderPacked10(fh, w, h) if args.packed10
             else YuvReader10(fh, w, h))
    else:
        r = YuvReader(fh, w, h)
    return r, w, h


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config_file:
        # file values become defaults; explicit CLI flags still win
        parser.set_defaults(**parse_config_file(args.config_file))
        args = parser.parse_args(argv)
    from svt_av1_tpu_torch.config import EncoderConfig
    from svt_av1_tpu_torch.io import IvfWriter, synthetic_frame
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    if args.nch > 1:
        return run_multichannel(args)
    if args.synthetic:
        if not (args.width and args.height):
            print("--synthetic requires -w and -h", file=sys.stderr)
            return 2
        frames = (synthetic_frame(args.width, args.height, seed=i,
                                  bit_depth=args.bit_depth)
                  for i in range(args.synthetic))
        width, height = args.width, args.height
    else:
        if not args.input:
            print("missing -i input (or --synthetic N)", file=sys.stderr)
            return 2
        reader, width, height = open_reader(args.input, args)
        frames = reader.frames()

    cfg = EncoderConfig(width=width, height=height, qp=args.qp,
                        enc_mode=args.preset, multi_ref=args.multi_ref,
                        bit_depth=args.bit_depth,
                        intra_period=args.intra_period,
                        pred_structure=args.pred_struct,
                        hierarchical_levels=args.hierarchical_levels,
                        tile_columns_log2=args.tiles_log2,
                        stat_report=args.stat_report,
                        rate_control_mode=args.rc_mode,
                        target_bit_rate=args.tbr,
                        look_ahead_distance=args.lookahead,
                        frame_rate_num=args.fps,
                        recon_output=bool(args.recon) or args.stat_report,
                        screen_content_mode=args.scm,
                        num_gop_shards=args.gop_shards)
    if args.gop_shards > 1 and (args.pred_struct != 0
                                or args.intra_period < 1):
        print("--gop-shards needs --pred-struct 0 and --intra-period >= 1",
              file=sys.stderr)
        return 2
    try:
        if args.gop_shards > 1:
            from svt_av1_tpu_torch.parallel import GopShardedEncoder
            enc = GopShardedEncoder(cfg, args.gop_shards,
                                    args.intra_period + 1,
                                    device=args.device)
        else:
            enc = Encoder(cfg, device=args.device)
    except (NotImplementedError, RuntimeError) as e:
        # a setting the port does not run yet, or no CUDA device
        print(f"enc_app: {e}", file=sys.stderr)
        return 2

    out = open(args.output, "wb") if args.output else None
    ivf = IvfWriter(out, width, height, args.fps, 1) if out else None
    rec_fh = open(args.recon, "wb") if args.recon else None
    stat_fh = open(args.stat_file, "w") if args.stat_file else None
    stats = {"bits": 0, "psnr": []}
    if stat_fh:
        args.stat_report = True
        stat_fh.write("frame\tbytes\tpsnr_y\tpsnr_u\tpsnr_v\n")

    t0 = time.perf_counter()
    state = {"n_out": 0, "total": 0, "pend": b""}
    rec_buf: dict = {}   # hier-B: recon arrives in decode order

    def write_rec(rc) -> None:
        for pl in (rc.y, rc.u, rc.v):
            rec_fh.write(pl.tobytes())

    def drain() -> None:
        while True:
            pkt = enc.get_packet()
            if pkt is None:
                return
            state["total"] += len(pkt.payload)
            if not pkt.show:
                # hier-B no-show TU: bundle into the IVF frame of the
                # next shown picture (one IVF frame per display step)
                state["pend"] += pkt.payload
            else:
                if ivf:
                    ivf.write_frame(state["pend"] + pkt.payload, pkt.pts)
                state["pend"] = b""
                state["n_out"] += 1
            if rec_fh:
                if pkt.display_idx is None:      # IPPP: in order
                    if pkt.recon is not None:
                        write_rec(pkt.recon)
                else:
                    if pkt.recon is not None:
                        rec_buf[pkt.display_idx] = pkt.recon
                    if pkt.show:
                        rc = rec_buf.pop(pkt.display_idx, None)
                        if rc is not None:
                            write_rec(rc)
            if args.stat_report and pkt.psnr:
                print(f"frame {pkt.pts}: {len(pkt.payload)} bytes, "
                      f"PSNR {pkt.psnr[0]:.2f}/{pkt.psnr[1]:.2f}/"
                      f"{pkt.psnr[2]:.2f}")
            if stat_fh and pkt.psnr:
                stats["bits"] += len(pkt.payload) * 8
                stats["psnr"].append(pkt.psnr)
                stat_fh.write(f"{pkt.pts}\t{len(pkt.payload)}\t"
                              f"{pkt.psnr[0]:.4f}\t{pkt.psnr[1]:.4f}\t"
                              f"{pkt.psnr[2]:.4f}\n")

    qp_overrides = None
    if args.qp_file:
        qp_overrides = []
        with open(args.qp_file) as fh:
            for line in fh:
                line = line.strip()
                qp_overrides.append(int(line) if line and line != "-1"
                                    else None)

    n_in = 0
    inj_t0 = time.perf_counter()
    for frame in frames:
        if args.frames and n_in >= args.frames:
            break
        if args.injector > 0:
            # pace sends to the injector rate (ref EbInjector: live
            # capture simulation — the encoder sees real-time arrival)
            due = inj_t0 + n_in / args.injector
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        if qp_overrides is not None:
            enc.push_qp(qp_overrides[n_in] if n_in < len(qp_overrides)
                        else None)
        enc.send_picture(frame)
        n_in += 1
        drain()
    enc.flush()
    drain()
    n_out, total = state["n_out"], state["total"]
    dt = time.perf_counter() - t0

    if ivf:
        ivf.finalize()
        out.close()
    if rec_fh:
        rec_fh.close()
    if stat_fh:
        import numpy as np
        if stats["psnr"]:
            m = np.mean(np.asarray(stats["psnr"]), axis=0)
            stat_fh.write(f"# summary: {n_out} frames, {stats['bits']} bits, "
                          f"mean PSNR {m[0]:.4f}/{m[1]:.4f}/{m[2]:.4f}\n")
        stat_fh.close()
    kbps = total * 8 * args.fps / max(n_out, 1) / 1000
    print(f"encoded {n_out} frames in {dt:.2f}s ({n_out / max(dt, 1e-9):.2f} "
          f"fps), {total} bytes (~{kbps:.0f} kbps @ {args.fps}fps) on "
          f"{enc.device}", file=sys.stderr)
    return 0


def run_multichannel(args) -> int:
    """--nch N lockstep channels (ref EbAppMain.c:196-215 multi-channel
    instances): N same-geometry streams batched per device step through
    MultiStreamEncoder; -i/-b take comma-separated per-channel paths."""
    from svt_av1_tpu_torch.config import EncoderConfig
    from svt_av1_tpu_torch.io import IvfWriter
    from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder

    n = args.nch
    ins = (args.input or "").split(",")
    outs = (args.output or "").split(",") if args.output else [None] * n
    if len(ins) != n or len(outs) != n:
        print("--nch N needs N comma-separated -i (and -b) paths",
              file=sys.stderr)
        return 2
    readers = []
    width = height = None
    for path in ins:
        r, w, h = open_reader(path, args)
        if width is None:
            width, height = w, h
        elif (w, h) != (width, height):
            print("all channels must share one geometry", file=sys.stderr)
            return 2
        readers.append(r.frames())
    cfg = EncoderConfig(width=width, height=height, qp=args.qp,
                        enc_mode=args.preset, bit_depth=args.bit_depth,
                        intra_period=args.intra_period, pred_structure=0,
                        recon_output=False,
                        scene_change_detection=False)
    try:
        ms = MultiStreamEncoder(cfg, n, device=args.device)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        # a setting the port does not run yet, or no CUDA device
        print(f"enc_app: {e}", file=sys.stderr)
        return 2
    writers = [IvfWriter(open(o, "wb"), width, height, args.fps, 1)
               if o else None for o in outs]
    t0 = time.perf_counter()
    done = 0
    while not args.frames or done < args.frames:
        batch = []
        for r in readers:
            f = next(r, None)
            if f is None:
                break
            batch.append(f)
        if len(batch) < n:
            break
        for ch, pkt in enumerate(ms.send(batch)):
            if writers[ch]:
                writers[ch].write_frame(pkt.payload, pkt.pts)
        done += 1
    for wtr in writers:
        if wtr:
            wtr.finalize()
            wtr.fh.close()
    dt = time.perf_counter() - t0
    print(f"encoded {done} frames x {n} channels in {dt:.2f}s "
          f"({done * n / max(dt, 1e-9):.2f} fps aggregate) on {ms.device}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
