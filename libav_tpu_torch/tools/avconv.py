"""avconv-semantics transcoder CLI (reference: avtools/avconv.c:2770
transcode loop, avconv_opt.c option grammar).

Usage mirrors avconv:
  avconv [global opts] -i INPUT [input opts before -i apply to it]
         [output opts] OUTPUT

Supported now: -i, -f, -c:v/-vcodec/-c:a/-acodec/-codec ('copy' works),
-pix_fmt, -s WxH, -q/-q:v (quality), -r (rate), -frames/-vframes, -an/-vn,
-y, -threads, -benchmark, -flags, -video_size, -pixel_format, -framerate
(rawvideo input), pipe ('-') and md5:/null outputs.

Pipeline per output stream: demux -> decode -> (filters: scale/format) ->
encode -> mux, with decode/encode device-batched inside the codecs.

This is the JAX package's CLI (libav_tpu/tools/avconv.py), copied, on the
port's codec table and devices:

    python -m libav_tpu_torch.tools.avconv -i in.h264 -f framecrc out.crc
    python -m libav_tpu_torch.tools.avconv -i in.m2v -c:v mpeg4 -q:v 6
        -g 12 -bf 2 -f m4v out.m4v          (one command: a transcode)
    python -m libav_tpu_torch.tools.avconv -i in.mkv -c:v mpeg4 -c:a aac
        out.mp4                             (a container transcode)

run on CUDA and exit nonzero with a message where there is none;
`main(argv, device="cpu")` runs the same path on the CPU. The
containers are the port's copies of the JAX package's (MOV/MP4,
Matroska/WebM and MPEG-TS among them). The decoders are the port's
(H.264 with kernel K1; MPEG-1/2, MPEG-4 part 2 from .m4v or AVI
FMP4/XVID/DIVX, and MJPEG with kernel K2) on that one device, and so are
the audio decoders (AAC with its IMDCT on the device; AC-3/E-AC-3,
MP1/2/3, FLAC and PCM on the host) and rawvideo (planes uploaded to the
device). `-s` and `-pix_fmt` run the port's swscale on the CLI's device
(YUV -> RGB through kernel `sws_yuv2rgb` on the card); `-ar`, `-ac` and
`-sample_fmt` run the port's avresample on the host. The encoders are
the host ones (rawvideo, PCM, MP1/2/3 and FLAC), the AAC and AC-3
encoders, whose MDCT runs on the CLI's device, and the MPEG-4 part 2
encoder (`-c:v mpeg4` with `-q:v`, `-g`, `-bf` and its pass-through
options, qpel and mpegq among them), whose device programs run on the
same device: decoded frames reach it as tensors there, with no trip to
the host. Any other encoder raises ENCODER_NOT_FOUND naming the
ROADMAP.md step that ports its device part. `-prof DIR` writes a
torch.profiler Chrome trace into DIR plus the host timer report (with
the H.264 decoder's `h264.entropy` span). Filter graphs (`-vf`, `-af`,
`-filter_complex`, the port's `filters/`) run on the same device: video
filters as torch programs on the decoded frames where they lie, audio
filters on the host sample planes; a `-filter_complex` input other than
the first is decoded up front on that device:

    python -m libav_tpu_torch.tools.avconv -i in.m2v -vf yadif=1
        -c:v mpeg4 -f m4v out.m4v
    python -m libav_tpu_torch.tools.avconv -i main.h264 -i logo.h264
        -filter_complex "[0:v][1:v]overlay=64:64" -f framecrc out.crc
    python -m libav_tpu_torch.tools.avconv -i in.ac3 -af volume=0.5
        -f s16le out.raw
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from libav_tpu_torch.avutil import hwdevice, log
from libav_tpu_torch.avutil.error import AVError, EAGAIN, EOF_
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.avutil.rational import NOPTS_VALUE, Rational, rescale_q
from libav_tpu_torch.codecs import (CodecParameters, find_decoder, find_encoder)
from libav_tpu_torch.codecs.api import MediaType
import libav_tpu_torch.codecs.rawvideo  # noqa: F401 (registration)
from libav_tpu_torch.formats import FormatContext


@dataclass
class OutputStreamSpec:
    codec: Optional[str] = None      # None = default for format, 'copy'
    extra: Dict[str, str] = field(default_factory=dict)
    pix_fmt: Optional[str] = None
    size: Optional[str] = None
    quality: Optional[int] = None
    rate: Optional[str] = None
    max_frames: Optional[int] = None
    sample_rate: Optional[int] = None
    channels: Optional[int] = None
    sample_fmt: Optional[str] = None
    vf: Optional[str] = None         # -vf/-af filtergraph description
    sws_flags: Optional[str] = None  # scaler algorithm name


def parse_time(v: str) -> float:
    """'[-][HH:]MM:SS[.m...]' or plain seconds (reference:
    av_parse_time / cmdutils)."""
    try:
        sign = -1.0 if v.startswith("-") else 1.0
        v2 = v.lstrip("+-")
        t = 0.0
        for part in v2.split(":"):
            t = t * 60 + float(part or 0)
        return sign * t
    except ValueError:
        raise AVError(-22, f"invalid time specification {v!r}")


@dataclass
class OutputGroup:
    """One output file with its own codec/map/trim options (reference:
    avconv_opt.c per-output OptionsContext)."""
    url: str = None
    format: Optional[str] = None
    video: OutputStreamSpec = None
    audio: OutputStreamSpec = None
    no_video: bool = False
    no_audio: bool = False
    maps: List[str] = field(default_factory=list)
    start_time: Optional[float] = None
    duration: Optional[float] = None
    extra: Dict[str, str] = field(default_factory=dict)


@dataclass
class Options:
    inputs: List[Dict[str, Any]] = field(default_factory=list)
    outputs: List[OutputGroup] = field(default_factory=list)
    output_url: Optional[str] = None
    start_time: Optional[float] = None   # -ss (output trim)
    duration: Optional[float] = None     # -t
    output_format: Optional[str] = None
    video: OutputStreamSpec = field(default_factory=OutputStreamSpec)
    audio: OutputStreamSpec = field(default_factory=OutputStreamSpec)
    no_video: bool = False
    no_audio: bool = False
    overwrite: bool = False
    benchmark: bool = False
    profile_dir: str = ""        # -prof DIR: torch.profiler trace + timers
    device: Any = None           # the torch device the decoders run on
    threads: int = 1
    filter_complex: Optional[str] = None
    extra: Dict[str, str] = field(default_factory=dict)
    # honest-option accounting: globally-scoped option names (post
    # _EXTRA_OPT_MAP) that may legitimately miss on one media type's
    # encoder, and name -> was-it-consumed-by-any-encoder
    shared_keys: set = field(default_factory=set)
    opt_consumed: Dict[str, bool] = field(default_factory=dict)


def parse_args(argv: List[str]) -> Options:
    """reference: avconv_opt.c (subset of the option grammar)"""
    o = Options()
    pending: Dict[str, str] = {}   # input options accumulated before -i
    cur_maps: List[str] = []
    i = 0

    def take():
        nonlocal i
        i += 1
        if i >= len(argv):
            raise AVError(-22, f"missing argument for {argv[i-1]}")
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a == "-i":
            url = take()
            o.inputs.append({"url": url, "opts": pending})
            pending = {}
        elif a in ("-f",):
            v = take()
            if o.inputs and o.output_url is None and not pending:
                o.output_format = v
            if not o.inputs:
                pending["format"] = v
            else:
                o.output_format = v
        elif a in ("-c", "-codec", "-c:v", "-vcodec", "-codec:v"):
            v = take()
            if a in ("-c", "-codec"):
                o.video.codec = o.audio.codec = v
            else:
                o.video.codec = v
        elif a in ("-c:a", "-acodec", "-codec:a"):
            o.audio.codec = take()
        elif a == "-pix_fmt":
            v = take()
            if not o.inputs:
                pending["pixel_format"] = v
            else:
                o.video.pix_fmt = v
        elif a == "-s":
            v = take()
            if not o.inputs:
                pending["video_size"] = v
            else:
                o.video.size = v
        elif a in ("-q", "-q:v", "-qscale", "-qscale:v"):
            o.video.quality = int(float(take()))
        elif a == "-r":
            v = take()
            if not o.inputs:
                pending["framerate"] = v
            else:
                o.video.rate = v
        elif a in ("-frames", "-vframes", "-frames:v"):
            o.video.max_frames = int(take())
        elif a in ("-aframes", "-frames:a"):
            o.audio.max_frames = int(take())
        elif a == "-ar":
            # input-side: declares the raw/pcm demuxer's rate (same
            # pending treatment as -r/-s; reference avconv_opt.c puts
            # pre--i options on the input)
            v = take()
            if not o.inputs:
                pending["sample_rate"] = v
            else:
                o.audio.sample_rate = int(v)
        elif a == "-ac":
            v = take()
            if not o.inputs:
                pending["channels"] = v
            else:
                o.audio.channels = int(v)
        elif a == "-sample_fmt":
            v = take()
            if not o.inputs:
                pending["sample_fmt"] = v
            else:
                o.audio.sample_fmt = v
        elif a == "-an":
            o.no_audio = True
        elif a == "-vn":
            o.no_video = True
        elif a == "-y":
            o.overwrite = True
        elif a == "-n":
            o.overwrite = False
        elif a == "-benchmark":
            o.benchmark = True
        elif a == "-prof":
            o.profile_dir = take()
        elif a == "-threads":
            o.threads = int(take())
        elif a in ("-video_size",):
            pending["video_size"] = take()
        elif a in ("-pixel_format",):
            pending["pixel_format"] = take()
        elif a in ("-framerate",):
            pending["framerate"] = take()
        elif a in ("-loglevel", "-v"):
            lvl = take()
            levels = {"quiet": log.QUIET, "error": log.ERROR,
                      "warning": log.WARNING, "info": log.INFO,
                      "verbose": log.VERBOSE, "debug": log.DEBUG}
            log.set_level(levels.get(lvl, log.INFO))
        elif a in ("-vf", "-filter:v"):
            o.video.vf = take()
        elif a in ("-af", "-filter:a"):
            o.audio.vf = take()
        elif a in ("-filter_complex", "-lavfi"):
            o.filter_complex = take()
        elif a == "-sws_flags":
            # accept the reference's spelling: algo[+accurate_rnd...]
            # (our scaler is always the bitexact/accurate_rnd chain)
            v = take()
            algo = [t for t in v.replace("+", " ").split()
                    if t not in ("accurate_rnd", "bitexact", "full_chroma_int",
                                 "full_chroma_inp", "print_info")]
            o.video.sws_flags = algo[0] if algo else None
        elif a == "-flags":
            o.extra["flags"] = take()
        elif a == "-b:v" or a == "-b":
            o.extra["bit_rate"] = take()
        elif a == "-g":
            o.extra["gop_size"] = take()
        elif a == "-bf":
            o.extra["max_b_frames"] = take()
        elif a == "-ss":
            o.start_time = parse_time(take())
        elif a == "-t":
            o.duration = parse_time(take())
        elif a == "-map":
            cur_maps.append(take())
        elif a in ("-stats", "-nostats", "-hide_banner"):
            pass                      # accepted no-op flags
        elif a.startswith("-") and a != "-":
            # pass-through encoder AVOption spellings take a value; any
            # other unknown option is a clean error (reference:
            # cmdutils.c parse_options "Unrecognized option")
            name = a[1:].split(":")[0]
            if name in _PASSTHRU_VALUE_OPTS:
                o.extra[a[1:]] = take()
            else:
                raise AVError(-22, f"Unrecognized option '{a}'")
        else:
            # an output URL closes the current output group; per-output
            # options reset for the next one (reference: avconv_opt.c
            # open_output_file)
            o.video.extra.update(o.extra)
            o.audio.extra.update(o.extra)
            o.shared_keys |= {_EXTRA_OPT_MAP.get(k, k) for k in o.extra}
            o.outputs.append(OutputGroup(
                url=a, format=o.output_format, video=o.video,
                audio=o.audio, no_video=o.no_video,
                no_audio=o.no_audio, maps=list(cur_maps),
                start_time=o.start_time, duration=o.duration,
                extra=dict(o.extra)))
            if o.output_url is None:
                o.output_url = a
            o.video = OutputStreamSpec()
            o.audio = OutputStreamSpec()
            o.no_video = o.no_audio = False
            o.output_format = None
            o.extra = {}
            cur_maps = []
        i += 1
    if o.outputs:
        g0 = o.outputs[0]
        o.video, o.audio = g0.video, g0.audio
        o.no_video, o.no_audio = g0.no_video, g0.no_audio
        o.output_format = g0.format
        o.extra = g0.extra
    return o


def _set_enc_opts(enc, enc_opts: Dict[str, Any], o: Options):
    """Apply encoder options honestly. An option unknown to this encoder
    is tolerated only when globally scoped (it may target the other media
    type's encoder); transcode() verifies afterwards that every global
    option was consumed somewhere. Accepting a flag and doing nothing is
    worse than rejecting it (reference: cmdutils.c parse_options)."""
    leftover = enc.set_opts(enc_opts, ignore_unknown=True)
    for k in enc_opts:
        if k in leftover:
            o.opt_consumed.setdefault(k, False)
        else:
            o.opt_consumed[k] = True
    hard = {k for k in leftover if k not in o.shared_keys}
    if hard:
        raise AVError(-22, f"option(s) not supported by encoder "
                           f"'{enc.NAME}': {', '.join(sorted(hard))}")


# encoder AVOption names accepted as pass-through "-name value" pairs
# (reference: every context exposes its AVOption table to the CLI)
_PASSTHRU_VALUE_OPTS = {
    "qp", "qmin", "qmax", "qcomp", "qblur", "qdiff", "rc_eq", "pass",
    "passlogfile", "maxrate", "minrate", "bufsize", "profile", "level",
    "me_range", "sc_threshold", "trellis", "aspect", "b_frames",
    "coder", "context", "refs", "dct", "idct", "mbd", "cmp", "subcmp",
    "b_strategy", "compression_level", "channel_layout", "dither",
    "deblock", "entropy", "i4x4", "parts", "weightp", "weightb", "tns",
    "slices", "i8x8", "dct8x8", "scmatrix", "cqpo", "cqpo2",
    "fieldpic", "fieldstress", "mbaff", "direct", "ipcm", "poc", "mmco",
    "fgap",
    "acpred", "mpegq", "bdirect", "qpel", "intensity", "pulse", "ltp",
    "lumi_masking", "dark_masking", "tcplx_masking", "scplx_masking",
    "p_masking", "border_masking", "mb_qmin", "mb_qmax",
    "data_partitioning",
    # reference CLI spellings (options_table.h:150-154)
    "lumi_mask", "dark_mask", "tcplx_mask", "scplx_mask", "p_mask",
    "border_mask",
}

# global per-codec option spellings -> encoder Option names
_EXTRA_OPT_MAP = {"max_b_frames": "b_frames", "bf": "b_frames",
                  "bit_rate": "bit_rate", "gop_size": "gop_size",
                  "qp": "qp", "flags": "flags",
                  "lumi_mask": "lumi_masking",
                  "dark_mask": "dark_masking",
                  "tcplx_mask": "tcplx_masking",
                  "scplx_mask": "scplx_masking",
                  "p_mask": "p_masking",
                  "border_mask": "border_masking"}


def _apply_extra(enc_opts: Dict[str, Any], extra: Dict[str, str]):
    for k, v in extra.items():
        name = _EXTRA_OPT_MAP.get(k, k)
        try:
            v = int(v)
        except (TypeError, ValueError):
            try:
                v = float(v)
            except (TypeError, ValueError):
                pass
        enc_opts[name] = v


_DEFAULT_VCODEC_FOR_FMT = {
    "framecrc": "rawvideo", "framemd5": "rawvideo", "crc": "rawvideo",
    "md5": "rawvideo", "rawvideo": "rawvideo", "yuv4mpegpipe": "rawvideo",
    "y4m": "rawvideo", "null": "rawvideo",
    "image2": "mjpeg", "mjpeg": "mjpeg", "avi": "mpeg4", "mp4": "mpeg4",
    "mov": "mpeg4", "mpegts": "mpeg2video", "wav": "pcm_s16le",
    "m4v": "mpeg4", "mpeg1video": "mpeg1video", "mpeg2video": "mpeg2video",
    "h264": "h264", "ac3": "ac3", "adts": "aac", "aac": "aac",
}


def _drain_frames(dec):
    out = []
    while True:
        try:
            out.append(dec.receive_frame())
        except AVError as e:
            if e.code in (EAGAIN, EOF_):
                return out
            raise


def _setup_filter_complex(o: Options, chains, vin):
    """Multi-input complex filtergraph (reference: avconv_filter.c
    configure_complex_filtergraph, subset): the grammar
    '[0:v][1:v]filter,chain[out]' binds input 0 as the chain's main
    feed and later labels to the multi-input filters (overlay) in
    order. Auxiliary inputs are decoded up front, on the CLI's device,
    and queued on the filter's secondary port."""
    import re as _re
    if vin is None or vin.index not in chains:
        raise AVError(-22, "filter_complex requires a video stream")
    spec = o.filter_complex.strip()
    labels = []
    while True:
        m = _re.match(r"\s*\[(\d+)(?::v(?::\d+)?)?\]", spec)
        if not m:
            break
        labels.append(int(m.group(1)))
        spec = spec[m.end():]
    spec = _re.sub(r"\[[A-Za-z_0-9]+\]\s*$", "", spec).strip()
    from libav_tpu_torch.filters.graph import FilterGraph
    g = FilterGraph(spec, device=o.device)
    ch = chains[vin.index]
    ch.graph = g
    multi = [f for f in g.filters if getattr(f, "N_INPUTS", 1) > 1]
    sec = labels[1:] if labels else []
    if len(sec) != len(multi):
        raise AVError(-22, "filter_complex: secondary input labels must "
                           "match the multi-input filters")
    for lab, filt in zip(sec, multi):
        if lab <= 0 or lab >= len(o.inputs):
            raise AVError(-22, f"filter_complex: bad input label {lab}")
        inp = o.inputs[lab]
        ic2 = FormatContext.open_input(inp["url"],
                                       inp["opts"].pop("format", None),
                                       inp["opts"] or None)
        vs = next((s for s in ic2.streams
                   if s.codecpar.codec_type == MediaType.VIDEO), None)
        if vs is None:
            raise AVError(-22, "auxiliary input has no video stream")
        dec2 = find_decoder(vs.codecpar.codec_id)(
            vs.codecpar, device=o.device).open()
        for pkt in ic2.packets():
            if pkt.stream_index != vs.index:
                continue
            dec2.send_packet(pkt)
            for fr in _drain_frames(dec2):
                filt.push_secondary(fr)
        try:
            dec2.send_packet(None)
        except AVError:
            pass
        for fr in _drain_frames(dec2):
            filt.push_secondary(fr)
        ic2.close()


class _GroupView:
    """Per-output-group view with the Options interface the chains
    consume (video/audio specs, trims, shared option accounting)."""

    def __init__(self, o: Options, g: OutputGroup):
        self.video = g.video
        self.audio = g.audio
        self.start_time = g.start_time
        self.duration = g.duration
        self.shared_keys = o.shared_keys
        self.opt_consumed = o.opt_consumed
        self.input_seeked = getattr(o, "input_seeked", False)
        self.device = o.device


def _resolve_map(ics, spec: str):
    """-map IN[:v|:a[:IDX]] | IN:STREAM -> [(input_idx, stream)]
    (reference: avconv_opt.c opt_map subset, no negative maps)."""
    parts = spec.split(":")
    try:
        ii = int(parts[0])
        ic = ics[ii]
    except (ValueError, IndexError):
        raise AVError(-22, f"invalid -map input index in {spec!r}")
    if len(parts) == 1:
        return [(ii, s) for s in ic.streams]
    if parts[1] in ("v", "a"):
        want = MediaType.VIDEO if parts[1] == "v" else MediaType.AUDIO
        matches = [s for s in ic.streams
                   if s.codecpar.codec_type == want]
        if len(parts) == 3:
            k = int(parts[2])
            if k >= len(matches):
                raise AVError(-22, f"-map {spec}: no such stream")
            matches = [matches[k]]
        if not matches:
            raise AVError(-22, f"-map {spec}: no matching stream")
        return [(ii, s) for s in matches]
    k = int(parts[1])
    if k >= len(ic.streams):
        raise AVError(-22, f"-map {spec}: no such stream")
    return [(ii, ic.streams[k])]


def transcode(o: Options) -> int:
    """reference: avconv.c:2770 transcode() — N inputs, M outputs with
    -map stream selection (default: first video + first audio of
    input 0)."""
    t0 = time.time()
    if not o.inputs:
        raise AVError(-22, "no input specified (-i)")
    if not o.outputs:
        raise AVError(-22, "no output specified")

    ics = [FormatContext.open_input(
        inp["url"], inp["opts"].pop("format", None), inp["opts"] or None)
        for inp in o.inputs]
    ic = ics[0]

    # fast input seek for -ss when the demuxer supports it (the frame-
    # accurate trim in the chains still drops anything before -ss)
    if o.start_time and o.start_time > 0:
        st0 = ic.streams[0]
        try:
            ic.seek(st0.index,
                    int(o.start_time * st0.time_base.den
                        / max(st0.time_base.num, 1)))
            o.input_seeked = True
        except AVError:
            pass                 # demuxer without seeking: decode+drop

    ocs = []
    consumers: Dict[tuple, list] = {}
    all_chains = []
    for g in o.outputs:
        oc = FormatContext.open_output(g.url, g.format)
        ocs.append(oc)
        gv = _GroupView(o, g)
        if g.maps:
            sel = []
            for m in g.maps:
                sel.extend(_resolve_map(ics, m))
        else:
            # default mapping: first video + first audio of input 0
            sel = []
            vin = next((s for s in ic.streams
                        if s.codecpar.codec_type == MediaType.VIDEO
                        and not g.no_video), None)
            ain = next((s for s in ic.streams
                        if s.codecpar.codec_type == MediaType.AUDIO
                        and not g.no_audio), None)
            sel = [(0, s) for s in (vin, ain) if s is not None]
        chains = {}
        for ii, ist in sel:
            t = ist.codecpar.codec_type
            if t == MediaType.VIDEO and not g.no_video:
                ch = _VideoChain(ist, oc, gv)
            elif t == MediaType.AUDIO and not g.no_audio:
                ch = _AudioChain(ist, oc, gv)
            else:
                continue
            consumers.setdefault((ii, ist.index), []).append(ch)
            chains[ist.index] = ch
            all_chains.append((oc, ch))
        if not chains:
            raise AVError(-22, f"no streams selected for {g.url}")
        if o.filter_complex and oc is ocs[0]:
            vin0 = next((s for s in ic.streams
                         if s.codecpar.codec_type == MediaType.VIDEO),
                        None)
            _setup_filter_complex(o, chains, vin0)

    packets_read = 0
    # input reader thread: demux/IO overlaps the decode pipeline
    # (reference: avconv.c:2386 input_thread)
    from libav_tpu_torch.parallel.prefetch import PacketPrefetcher
    for ii, icx in enumerate(ics):
        if not any(k[0] == ii for k in consumers):
            continue
        pf = PacketPrefetcher(icx)
        try:
            for pkt in pf:
                chs = consumers.get((ii, pkt.stream_index))
                if not chs:
                    continue
                packets_read += 1
                for ch in chs:
                    ch.send(pkt)
                    if ch.done:
                        ch.oc.write_stream_eof(ch.ost.index)
                if all(c.done for _, c in all_chains):
                    break
        finally:
            pf.close()
    for oc, ch in all_chains:
        ch.drain()
        oc.write_stream_eof(ch.ost.index)
    for oc in ocs:
        oc.write_trailer()
    for icx in ics:
        icx.close()

    # honest options: a globally-scoped encoder option that no encoder
    # in the job consumed is an error, not a silent no-op
    dead = sorted(k for k, used in o.opt_consumed.items() if not used)
    if dead:
        raise AVError(-22, f"option(s) not consumed by any encoder: "
                           f"{', '.join(dead)}")

    if packets_read == 0:
        sys.stderr.write("avconv: no packets read from input — "
                         "output file is empty\n")
        return 1

    if o.benchmark:
        dt = time.time() - t0
        total = sum(c.frame_count for _, c in all_chains)
        sys.stderr.write(f"bench: utime={dt:.3f}s frames={total} "
                         f"fps={total/dt if dt else 0:.1f}\n")
    return 0


def _ts_valid(v) -> bool:
    from libav_tpu_torch.avutil.rational import NOPTS_VALUE
    return v is not None and v != NOPTS_VALUE


class _PtsCorrection:
    """Pick between a decoded frame's reordered pts and the dts of the
    packet that returned it (port of the reference's guess_correct_pts,
    avtools/cmdutils.c:1438): whichever timeline has accumulated fewer
    non-monotonicities wins.  Raw video ES (no container timestamps)
    thus gets the triggering-packet dts chain, while container inputs
    with sane pts keep their pts."""

    def __init__(self):
        self.num_faulty_pts = 0
        self.num_faulty_dts = 0
        self.last_pts = None
        self.last_dts = None

    def guess(self, reordered_pts, dts):
        if _ts_valid(dts):
            if self.last_dts is not None and dts <= self.last_dts:
                self.num_faulty_dts += 1
            self.last_dts = dts
        if _ts_valid(reordered_pts):
            if self.last_pts is not None and reordered_pts <= self.last_pts:
                self.num_faulty_pts += 1
            self.last_pts = reordered_pts
        if (self.num_faulty_pts <= self.num_faulty_dts
                or not _ts_valid(dts)) and _ts_valid(reordered_pts):
            return reordered_pts
        return dts if _ts_valid(dts) else None


class _VideoChain:
    def __init__(self, ist, oc: FormatContext, o: Options):
        self.ist = ist
        self.oc = oc
        self.o = o
        self.spec = o.video
        self.done = False
        self.frame_count = 0
        self.trim_start = o.start_time
        self.trim_dur = o.duration
        self.seek_base = getattr(o, "input_seeked", False)
        self._clock_frames = 0
        self._clock_samples = 0
        self._pts_ctx = _PtsCorrection()
        self._next_out_pts = None     # vsync fill for NOPTS frames

        par = ist.codecpar
        codec_name = self.spec.codec
        if codec_name is None:
            fmt_name = oc.oformat.NAME.split(",")[0]
            codec_name = _DEFAULT_VCODEC_FOR_FMT.get(fmt_name,
                                                     oc.oformat.VIDEO_CODEC)
        self.copy = codec_name == "copy"

        out_par = CodecParameters(
            codec_type=MediaType.VIDEO, codec_id=codec_name if not self.copy
            else par.codec_id,
            width=par.width, height=par.height, pix_fmt=par.pix_fmt)
        self.ost = oc.new_stream(out_par, time_base=ist.time_base)
        self.ost.avg_frame_rate = ist.avg_frame_rate

        if self.copy:
            self.dec = self.enc = None
            return
        self.dec = find_decoder(par.codec_id)(par, device=o.device).open()
        if self.spec.size:
            w, h = (int(x) for x in self.spec.size.lower().split("x"))
            out_par.width, out_par.height = w, h
        enc_opts = {}
        if self.spec.quality is not None:
            # -q/-qscale semantics (1-31, lower = better), like the
            # reference; encoders map it to their own quality notion
            enc_opts["qscale"] = self.spec.quality
        _apply_extra(enc_opts, self.spec.extra)
        self.enc = None
        self.enc_name = codec_name
        self.enc_opts = enc_opts
        self.out_par = out_par
        self.graph = None
        if getattr(self.spec, "vf", None):
            from libav_tpu_torch.filters.graph import FilterGraph
            self.graph = FilterGraph(self.spec.vf, device=o.device)

    def _ensure_encoder(self, frame: Frame):
        if self.enc is not None or self.copy:
            return
        self.out_par.width = self.out_par.width or frame.width
        self.out_par.height = self.out_par.height or frame.height
        self.out_par.pix_fmt = self.spec.pix_fmt or frame.format
        cls = find_encoder(self.enc_name)
        # device encoders run where the decoders do: decoded frames reach
        # them as tensors on that device
        self.enc = cls(self.out_par, device=self.o.device) \
            if cls.DEVICE_PART else cls(self.out_par)
        _set_enc_opts(self.enc, self.enc_opts, self.o)
        self.enc.open()

    def send(self, pkt: Packet):
        if self.done:
            return
        if self.copy:
            # stream copy: trim on packet timestamps (keyframe-imprecise
            # for video, like the reference's -c copy -ss)
            if self.trim_start is not None or self.trim_dur is not None:
                t = None
                if pkt.pts is not None and pkt.time_base and \
                        pkt.time_base.den:
                    t = float(pkt.pts * pkt.time_base.num /
                              pkt.time_base.den)
                if t is not None:
                    ss = self.trim_start or 0.0
                    if t < ss:
                        return
                    if self.trim_dur is not None and \
                            t - ss >= self.trim_dur:
                        self.done = True
                        return
            self._write(pkt)
            self.frame_count += 1
            if (self.spec.max_frames is not None
                    and self.frame_count >= self.spec.max_frames):
                self.done = True
            return
        self.dec.send_packet(pkt)
        self._pump_frames()

    def _frame_time(self, frame: Frame) -> float:
        if frame.pts is not None and frame.time_base and \
                frame.time_base.den:
            return float(frame.pts * frame.time_base.num /
                         frame.time_base.den)
        # fall back to a frame/sample counter clock; if the demuxer seek
        # for -ss succeeded, the counter starts at -ss already
        base = self.trim_start or 0.0 if getattr(self, "seek_base", False) \
            else 0.0
        if frame.width:
            fr = self.ist.avg_frame_rate
            fps = float(fr) if fr and fr.num else 25.0
            return base + self._clock_frames / fps
        return base + self._clock_samples / max(frame.sample_rate or 48000,
                                                1)

    def _pump_frames(self):
        while True:
            try:
                frame = self.dec.receive_frame()
            except AVError as e:
                if e.code in (EAGAIN, EOF_):
                    return
                raise
            if frame.width:
                # reference avconv.c:1427: decoded video pts is the
                # best-effort pick between reordered pts and the
                # returning packet's dts
                frame.pts = self._pts_ctx.guess(frame.pts, frame.pkt_dts)
            t = self._frame_time(frame)
            self._clock_frames = getattr(self, "_clock_frames", 0) + 1
            self._clock_samples = getattr(self, "_clock_samples", 0) + \
                (frame.nb_samples or 0)
            ss = self.trim_start
            if ss is not None and t < ss:
                continue                      # output -ss: decode + drop
            if self.trim_dur is not None and \
                    t - (ss or 0.0) >= self.trim_dur:
                self.done = True
                return
            for f in self._filter(frame):
                self._encode_frame(f)
            if self.done:
                return

    def _filter(self, frame: Frame) -> List[Frame]:
        if self.graph is not None:
            return [self._scale(f) for f in self.graph.push(frame)]
        return [self._scale(frame)]

    def _scale(self, frame: Frame) -> Frame:
        spec = self.spec
        if spec.size or (spec.pix_fmt and spec.pix_fmt != frame.format):
            from libav_tpu_torch.swscale import SwsContext
            w = frame.width
            h = frame.height
            if spec.size:
                w, h = (int(x) for x in spec.size.lower().split("x"))
            dst_fmt = spec.pix_fmt or frame.format
            from libav_tpu_torch import swscale as _sw
            flg = {"bilinear": _sw.BILINEAR, "bicubic": _sw.BICUBIC,
                   "neighbor": _sw.POINT, "point": _sw.POINT,
                   "area": _sw.AREA, "lanczos": _sw.LANCZOS,
                   "spline": getattr(_sw, "SPLINE", _sw.BICUBIC),
                   }.get(getattr(spec, "sws_flags", None) or "bicubic",
                         _sw.BICUBIC)
            sws = SwsContext.get(frame.width, frame.height, frame.format,
                                 w, h, dst_fmt, flags=flg,
                                 device=self.o.device)
            frame = sws.scale_frame(frame)
        return frame

    def _encode_frame(self, frame: Frame):
        # -frames/-aframes limits frames SENT to the encoder (reference
        # avconv.c ost->frame_number check before do_video_out), so N
        # frames yield exactly N packets even with B-frame delay — the
        # delayed packets surface in drain()'s encoder flush.
        if (self.spec.max_frames is not None
                and self.frame_count >= self.spec.max_frames):
            self.done = True
            return
        if frame.width:
            # frames without a usable timestamp (raw-ES drain tail)
            # continue the output clock (reference do_video_out
            # sync_opts fill)
            if not _ts_valid(frame.pts):
                frame.pts = (self._next_out_pts
                             if self._next_out_pts is not None else 0)
            self._next_out_pts = frame.pts + 1
        self._ensure_encoder(frame)
        self.enc.send_frame(frame)
        self.frame_count += 1
        if (self.spec.max_frames is not None
                and self.frame_count >= self.spec.max_frames):
            self.done = True
        self._pump_packets()

    def _pump_packets(self):
        while True:
            try:
                pkt = self.enc.receive_packet()
            except AVError as e:
                if e.code in (EAGAIN, EOF_):
                    return
                raise
            self._write(pkt)

    def _write(self, pkt: Packet):
        pkt = pkt.clone()
        pkt.stream_index = self.ost.index
        self.oc.write_packet(pkt)

    def drain(self):
        if self.copy:
            return
        if not self.done:
            try:
                self.dec.send_packet(None)
            except AVError:
                pass
            self._pump_frames()
            rs = getattr(self, "_resampler", None)
            if rs is not None and not self.done:
                tail = rs.flush_resampler()
                if tail is not None:
                    self._encode_frame(tail)
            if getattr(self, "graph", None) is not None and not self.done:
                for f in self.graph.push_eof():
                    self._encode_frame(self._scale(f))
        # the encoder is flushed even when a -frames/-t limit stopped
        # the feed: its reorder queue still holds packets for frames
        # already sent (B-frame delay)
        if self.enc is not None:
            try:
                self.enc.send_frame(None)
            except AVError:
                pass
            self._pump_packets()


class _AudioChain(_VideoChain):
    def __init__(self, ist, oc, o: Options):
        self.ist = ist
        self.oc = oc
        self.o = o
        self.spec = o.audio
        self.done = False
        self.frame_count = 0
        self.trim_start = o.start_time
        self.trim_dur = o.duration
        self.seek_base = getattr(o, "input_seeked", False)
        self._clock_frames = 0
        self._clock_samples = 0
        par = ist.codecpar
        codec_name = self.spec.codec
        if codec_name is None:
            fmt_name = oc.oformat.NAME.split(",")[0]
            codec_name = {"wav": "pcm_s16le", "framecrc": "pcm_s16le",
                          "framemd5": "pcm_s16le", "null": "pcm_s16le",
                          }.get(fmt_name, oc.oformat.AUDIO_CODEC)
        # stream copy ONLY when the user explicitly asked for it, or when
        # the default codec matches AND nothing requires a re-encode
        # (-ar/-ac/-sample_fmt/-ss/-t all take the decode->filter->encode
        # path; reference avconv re-encodes unless '-c copy' is given)
        needs_reencode = (self.spec.sample_rate or self.spec.channels
                          or self.spec.sample_fmt
                          or getattr(self.spec, "vf", None)
                          or o.start_time is not None
                          or o.duration is not None)
        self.copy = codec_name == "copy" or (
            self.spec.codec is None and codec_name == par.codec_id
            and not needs_reencode)
        out_par = CodecParameters(
            codec_type=MediaType.AUDIO,
            codec_id=par.codec_id if self.copy else codec_name,
            sample_fmt=par.sample_fmt, sample_rate=par.sample_rate,
            channels=par.channels, channel_layout=par.channel_layout)
        self.ost = oc.new_stream(out_par, time_base=ist.time_base)
        if self.copy:
            self.dec = self.enc = None
            return
        self.dec = find_decoder(par.codec_id)(par, device=o.device).open()
        self.enc_name = codec_name
        self.enc_opts = {}
        _apply_extra(self.enc_opts, self.spec.extra)
        self.out_par = out_par
        self.enc = None
        self.graph = None
        if getattr(self.spec, "vf", None):
            from libav_tpu_torch.filters.graph import FilterGraph
            self.graph = FilterGraph(self.spec.vf, device=o.device)

    def _filter(self, frame: Frame) -> List[Frame]:
        spec = self.spec
        if self.graph is not None:
            return [g for f in self.graph.push(frame)
                    for g in self._convert(f)]
        return self._convert(frame)

    def _convert(self, frame: Frame) -> List[Frame]:
        spec = self.spec
        need = ((spec.sample_rate and spec.sample_rate != frame.sample_rate)
                or (spec.channels and spec.channels != frame.channels)
                or (spec.sample_fmt and spec.sample_fmt != frame.format))
        if not need:
            return [frame]
        if getattr(self, "_resampler", None) is None:
            from libav_tpu_torch.avresample import AudioResampler
            from libav_tpu_torch.avutil.samplefmt import \
                default_channel_layout
            self._resampler = AudioResampler(
                in_sample_rate=frame.sample_rate,
                out_sample_rate=spec.sample_rate or frame.sample_rate,
                in_sample_fmt=frame.format,
                out_sample_fmt=spec.sample_fmt or frame.format,
                in_channel_layout=frame.channel_layout or
                default_channel_layout(frame.channels),
                out_channel_layout=default_channel_layout(
                    spec.channels or frame.channels),
            ).open()
        return [self._resampler.convert(frame)]

    def _ensure_encoder(self, frame: Frame):
        if self.enc is not None or self.copy:
            return
        self.out_par.sample_fmt = frame.format
        self.out_par.sample_rate = frame.sample_rate
        self.out_par.channels = frame.channels
        cls = find_encoder(self.enc_name)
        # the AAC and AC-3 encoders run their MDCT on the CLI's device
        self.enc = cls(self.out_par, device=self.o.device) \
            if cls.DEVICE_PART else cls(self.out_par)
        _set_enc_opts(self.enc, self.enc_opts, self.o)
        self.enc.open()


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(__doc__ + "\n")
        return 0
    try:
        dev = hwdevice.device(device)
    except RuntimeError as e:
        sys.stderr.write(f"avconv: {e}\n")
        return 1
    try:
        o = parse_args(argv)
        o.device = dev
        if o.profile_dir:
            # structured device tracing (SURVEY.md §5): one xplane
            # trace for the whole run + the host timer histogram
            from libav_tpu_torch.avutil import timer as _timer
            _timer.reset()
            with _timer.device_trace(o.profile_dir):
                rc = transcode(o)
            rep = _timer.report()
            if rep:
                sys.stderr.write(rep + "\n")
            sys.stderr.write(f"profile: xplane trace in "
                             f"{o.profile_dir}\n")
            return rc
        return transcode(o)
    except AVError as e:
        sys.stderr.write(f"avconv: {e}\n")
        return 1
    except OSError as e:
        sys.stderr.write(f"avconv: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
