"""H.264 decoder host side (reference: h264dec.c decode_nal_units :520,
h264_slice.c slice header + per-MB loop :2361-2428, h264_cavlc.c
ff_h264_decode_mb_cavlc :699, h264_cabac.c :1908; device half in
device.py).

Coverage: CAVLC + CABAC entropy (Python reference layers plus native C
production decoders); I_16x16 and I_4x4 intra; P/B slices with every
partition and sub-partition shape, P_Skip/B_Skip, spatial direct,
multi-reference lists, weighted prediction (explicit + implicit);
POC-ordered DPB output reorder; normative in-loop deblocking (two-list
block-granular bS); multi-slice frames with slice-parallel entropy;
frame-pipelined host entropy vs device recon; mid-slice error
concealment; ref_pic_list_modification (short + long-term); full MMCO
1-6 + long-term references; High-profile 8x8 transform/I_8x8 + scaling
matrices; spatial + temporal direct; I_PCM; poc_type 0/1/2;
gaps_in_frame_num; PAFF field pictures (both directions, CAVLC +
CABAC, cross-parity chroma MV offset, complementary-pair weave);
MBAFF all-field frame pictures (I + P, both
coders: pair-interleaved walk over the stacked field layout, 7.3.4
mb_skip-before-mb_field_decoding_flag ordering, doubled
MbaffRefPicList ref_idx, per-parity field-view recon).
Not yet: MBAFF frame-coded/mixed pairs, MBAFF B, High10/4:2:2/4:4:4,
FMO/ASO.

This is the JAX package's host decoder, copied (libav_tpu/codecs/h264/
dec.py), with the port's device half. An access unit's slices are
entropy-decoded by one of three engines, which `_engine` chooses at the
AU's first slice and `FrameData.engine` carries to every later reader:
"cabac" (native/cabac.c, frame and field pictures; the JAX package
takes the Python path for field pictures), "cavlc" (native/
h264_cavlc.c, I and P frame pictures, per-MB motion only) or "python",
the twin (_decode_mbs, _decode_mbs_cabac), which takes whatever the C
declines and which native.build.disabled() selects for tests.
`_reconstruct` assembles the same host arguments and runs the port's
program (device.recon_h264_sparse) on the decoder's torch device,
uploading the numpy inputs synchronously on the thread that calls it;
the entropy worker thread makes no CUDA call. A PAFF field pair and the
two parities of an all-field MBAFF frame are woven on that device
(`_weave_fields`).
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from libav_tpu_torch.avutil import log
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet, PictureType
from libav_tpu_torch.avutil.rational import NOPTS_VALUE
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.h264 import cavlc, nal as nal_mod, part, sets
from libav_tpu_torch.avutil import hwdevice, timer
from libav_tpu_torch.codecs.h264 import device as _device
from libav_tpu_torch.codecs.h264.part import MotionGrids

GOLOMB_TO_INTRA_CBP = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41]
GOLOMB_TO_INTER_CBP = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41]

SLICE_P, SLICE_B, SLICE_I = 0, 1, 2


class _NativeUnsupported(Exception):
    """A slice holds a construct outside its native engine's subset;
    the caller redoes the access unit on the twin."""


def _engine(cabac: bool, slice_type: int, field_pic: bool, mbaff: bool,
            temporal: bool, twin: bool) -> str:
    """The entropy engine that can decode a slice: "cabac", "cavlc" or
    "python". cabac: the PPS's entropy_coding_mode; temporal: a B slice
    with temporal direct prediction; twin: the access unit is being
    redone on the twin."""
    from libav_tpu_torch.native import build, h264_cabac_host, h264_cavlc
    if twin or mbaff or temporal or build.disabled():
        return "python"
    if cabac:
        return "cabac" if h264_cabac_host.available() else "python"
    if slice_type != SLICE_B and not field_pic and h264_cavlc.available():
        return "cavlc"
    return "python"


def _mb_blocks(fd):
    """The cavlc engine's per-MB motion spread over the 4x4-block grid:
    (ref (bh, bw), mv (bh, bw, 2)), ref NOREF in intra MBs."""
    g = fd.grids
    mbh, mbw = g.bh // 4, g.bw // 4
    ref = np.where(fd.intra.astype(bool).reshape(mbh, mbw), part.NOREF,
                   fd.ref_idx.reshape(mbh, mbw))
    mv = fd.mv.reshape(mbh, mbw, 2)
    return (np.repeat(np.repeat(ref, 4, 0), 4, 1),
            np.repeat(np.repeat(mv, 4, 0), 4, 1))


class DPBEntry:
    """Decoded reference picture (reference: h264dec.h H264Picture):
    POC, frame_num (for PicNum reordering/MMCO), padded planes, and the
    saved block motion for spatial-direct colocated lookups
    (h264_direct.c)."""
    __slots__ = ("poc", "planes", "colref", "colmv", "colpoc",
                 "colpacked", "frame_num", "long_term", "lt_idx", "src",
                 "field_poc", "field_planes", "field_src")

    def __init__(self, poc, planes, colpacked=None, frame_num=0):
        self.poc = poc
        self.planes = planes
        # packed (bh, bw, 4) int32 of (ref, mvx, mvy, refpoc) per 4x4
        # cell — colref/colmv/colpoc are strided views into it (one
        # contiguous buffer: built in one native pass and handed to the
        # C spatial-direct reader without repacking)
        self.colpacked = colpacked
        if colpacked is not None:
            self.colref = colpacked[..., 0]
            self.colmv = colpacked[..., 1:3]
            self.colpoc = colpacked[..., 3]
        else:
            self.colref = self.colmv = self.colpoc = None
        self.long_term = False         # 8.2.5: long-term reference
        self.lt_idx = -1               # LongTermFrameIdx
        self.src = None                # gap dummy: copy-of entry
        self.frame_num = frame_num
        self.field_poc = None          # {parity: poc} for PAFF frames
        self.field_planes = None       # {parity: padded field planes}
        self.field_src = None          # field view: (frame entry, par)


class _GolombReader:
    """CAVLC side of the shared inter-MB parse interface (the CABAC side
    is CabacMbLayer); block coordinates are accepted and ignored."""

    def __init__(self, gb):
        self.gb = gb

    def sub_mb_type_p(self) -> int:
        v = self.gb.get_ue_golomb()
        if v > 3:
            raise AVError(INVALIDDATA, f"P sub_mb_type {v} out of range")
        return v

    def sub_mb_type_b(self) -> int:
        v = self.gb.get_ue_golomb()
        if v > 12:
            raise AVError(INVALIDDATA, f"B sub_mb_type {v} out of range")
        return v

    def ref_idx(self, lst, bx, by, nref) -> int:
        if nref == 2:                       # te(v), spec 9.1.1
            return 1 - self.gb.get_bits(1)
        return self.gb.get_ue_golomb()

    def mvd(self, lst, bx, by, comp) -> int:
        return self.gb.get_se_golomb()

    def motion(self, lst, bx, by, pred):
        mvdx = self.gb.get_se_golomb()
        mvdy = self.gb.get_se_golomb()
        return (pred[0] + mvdx, pred[1] + mvdy), (mvdx, mvdy)

_BLK_XY = [(2 * ((i >> 2) & 1) + (i & 1), 2 * (i >> 3) + ((i >> 1) & 1))
           for i in range(16)]


def pred_i4_mode(grid, gx, gy) -> int:
    """predIntra4x4PredMode (spec 8.3.1.1): min of the left/top blocks'
    modes; 2 (DC) when either neighbor is unavailable. grid holds -1 for
    not-yet-decoded/unavailable, 2 for non-I4x4 coded MBs."""
    a = int(grid[gy, gx - 1]) if gx > 0 else -1
    b = int(grid[gy - 1, gx]) if gy > 0 else -1
    m = min(a, b)
    return 2 if m < 0 else m


class FrameData:
    """One access unit's entropy output, in the layout of its engine
    (`_engine`): "python", dense numpy arrays; "cavlc", views of one
    int32 block that native/h264_cavlc.c fills, with the coded blocks'
    coefficient lists in `sparse`; "cabac", views of the arena that
    native/cabac.c fills (H264Decoder._frame_data attaches them), with
    `sparse` likewise."""

    def __init__(self, nmb, mb_w, mb_h, engine="python"):
        self.engine = engine
        # block-granular motion state (partitions, direct, CABAC ctx)
        self.grids = MotionGrids(mb_w, mb_h, alloc=engine != "cabac")
        self.nslices = 0
        self.slice_starts = []
        # 8x8 transform flag per MB (High profile); shared by all paths
        self.transform8 = np.zeros(nmb, dtype=bool)
        # B-slice reference lists (DPB entries), set per slice
        self.list0 = self.list1 = None
        # B-slice state: per-MB list selection (0=L0 1=L1 2=Bi) and
        # list-1 motion
        self.sel = np.zeros(nmb, dtype=np.int8)
        self.mv1 = np.zeros((nmb, 2), dtype=np.int32)
        self.i4_grid = np.full((4 * mb_h, 4 * mb_w), -1, dtype=np.int8)
        if engine == "cabac":
            return
        self.i4 = np.zeros(nmb, dtype=bool)
        self.i4_modes = np.full((nmb, 16), 2, dtype=np.int8)
        self.ref_idx = np.zeros(nmb, dtype=np.int32)
        if engine == "cavlc":
            # contiguous int32 block shared zero-copy with the native
            # CAVLC slice decoder
            from libav_tpu_torch.native import h264_cavlc as N
            self.block = N.alloc_block(nmb)
            v = N.views(self.block, nmb, mb_w, mb_h)
            self.intra = v["intra"]          # int32 0/1
            self.luma_mode = v["luma_mode"]
            self.chroma_mode = v["chroma_mode"]
            self.mv = v["mv"]
            self.qp = v["qp"]
            self.qp[:] = 26
            self.luma_dc = v["luma_dc"]
            self.luma_ac = v["luma_ac"]
            self.chroma_dc = v["chroma_dc"]
            self.chroma_ac = v["chroma_ac"]
            self.nnz_y = v["nnz_y"]
            self.nnz_u = v["nnz_u"]
            self.nnz_v = v["nnz_v"]
            self.coded = v["coded"]
            self.sparse = N.alloc_sparse(nmb)
            return
        self.nnz_y = np.zeros((4 * mb_h, 4 * mb_w), dtype=np.int32)
        self.nnz_u = np.zeros((2 * mb_h, 2 * mb_w), dtype=np.int32)
        self.nnz_v = np.zeros_like(self.nnz_u)
        self.intra = np.zeros(nmb, dtype=bool)
        self.luma_mode = np.zeros(nmb, dtype=np.int32)
        self.chroma_mode = np.zeros(nmb, dtype=np.int32)
        self.mv = np.zeros((nmb, 2), dtype=np.int32)
        self.qp = np.full(nmb, 26, dtype=np.int32)
        self.luma_dc = np.zeros((nmb, 16), dtype=np.int32)
        self.luma_ac = np.zeros((nmb, 16, 16), dtype=np.int32)
        self.chroma_dc = np.zeros((nmb, 2, 4), dtype=np.int32)
        self.chroma_ac = np.zeros((nmb, 8, 16), dtype=np.int32)
        self.coded = np.zeros(nmb, dtype=bool)
        self.ref_idx = np.zeros(nmb, dtype=np.int32)


@register_codec
class H264Decoder(Decoder):
    NAME = "h264"
    TYPE = MediaType.VIDEO
    LONG_NAME = "H.264/AVC (PyTorch device reconstruction)"

    def __init__(self, params=None, options=None, *, device="cuda"):
        """H264Decoder(params, options, device="cuda"|"cpu") — planes of
        the output frames (and of the DPB) are uint8 tensors on
        `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        # settle any in-flight entropy job before resetting state
        self._settle()
        self.sps: Dict[int, sets.SPS] = {}
        self.pps: Dict[int, sets.PPS] = {}
        self.active_sps: Optional[sets.SPS] = None
        self.active_pps: Optional[sets.PPS] = None
        self._dpb = []           # [(poc, padded plane tuple)], newest first
        self._deblock_warned = False
        self._poc_state = (0, 0)      # prevPocMsb, prevPocLsb (spec 8.2.1.1)
        self._outq = []               # POC output reorder (h264_refs.c
        self._reorder = False         # select_output_frame analogue)
        self._pts_pool = []           # input pts awaiting display order
        self._exec = None             # entropy/recon worker (pipeline)
        self._au_fut = None           # in-flight AU entropy future
        self._au_count = 0            # AUs sent, in decode order
        self._incomplete_field = None  # PAFF: (entry, parity, frame_num)
        self._field_out = None         # PAFF: first field awaiting weave

    _cur_col = None
    _cur_lists = ([], [])
    _cur_field = (0, 0, False)

    def _settle(self):
        """Wait for the in-flight entropy job, if any, and drop it."""
        fut = getattr(self, "_au_fut", None)
        if fut is not None:
            try:
                fut.result()
            except Exception:
                pass
            self._au_fut = None

    def close(self):
        # settle and join the entropy worker, so that no thread of this
        # codec outlives it
        self._settle()
        ex = getattr(self, "_exec", None)
        if ex is not None:
            ex.shutdown(wait=True)
            self._exec = None
        super().close()

    def _flush(self):
        self._settle()
        self._dpb = []
        self._outq = []
        self._poc_state = (0, 0)
        self._pts_pool = []
        self._incomplete_field = None
        self._field_out = None

    # ------------------------------------------------------------------ #

    REORDER_DEPTH = 2

    def _decode(self, pkt: Packet) -> List[Frame]:
        # frame pipeline (reference: pthread_frame.c submit/return
        # delay): the host entropy of access unit N+1 runs on a worker
        # thread while the device reconstructs N — the C entropy layer
        # releases the GIL, so the stages genuinely overlap. Output is
        # delayed by one AU (codec delay, drained on flush).
        # the access unit's number in decode order: the tag of its spans
        au = self._au_count
        self._au_count += 1
        if (os.cpu_count() or 1) <= 1:
            # one host core leaves the worker nothing to overlap on: it
            # would only add GIL handoffs and thread switches, so decode
            # in line
            done = concurrent.futures.Future()
            done.set_result(self._entropy_au(pkt, au))
            return self._finish_au(done, au)
        if self._exec is None:
            self._exec = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="h264-entropy")
        fut_prev = self._au_fut
        self._au_fut = self._exec.submit(self._entropy_au, pkt, au)
        if fut_prev is None:
            return []
        return self._finish_au(fut_prev, au - 1)

    def _entropy_au(self, pkt: Packet, au: int):
        """Worker-side: all host entropy for one AU (headers + MB
        layer + DPB bookkeeping); no device work."""
        try:
            fd, slice_info = self._entropy_nals(pkt, au)
        except _NativeUnsupported:
            # a slice uses a construct outside its native engine's
            # subset: redo the whole access unit on the twin
            fd, slice_info = self._entropy_nals(pkt, au, twin=True)
        if fd is not None and getattr(fd, "list0", None) is None:
            # snapshot: the recon may run on a worker while the main
            # thread's entropy of the next AU mutates the DPB
            fd.list0 = list(self._dpb)
        return fd, slice_info, pkt

    @staticmethod
    def _weave_fields(top: Frame, bot: Frame) -> Frame:
        """Complementary field pair -> frame (reference: h264_slice.c
        field pairing / av_image weave on output). The fields' planes
        are tensors on the decoder's device: two strided copies per
        plane there, no download."""
        out = top.clone_props()
        out.height = top.height + bot.height
        out.interlaced_frame = True
        out.top_field_first = True
        planes = []
        for t, b in zip(top.planes, bot.planes):
            w = torch.empty((t.shape[0] + b.shape[0], t.shape[1]),
                            dtype=t.dtype, device=t.device)
            w[0::2] = t
            w[1::2] = b
            planes.append(w)
        out.planes = planes
        out.poc = min(getattr(top, "poc", 0), getattr(bot, "poc", 0))
        out.key_frame = top.key_frame or bot.key_frame
        return out

    def _recon_mbaff(self, fd: FrameData, slice_info) -> Frame:
        """All-field MBAFF frame: the stacked entropy layout (MB rows
        0..H/2-1 = top field image) splits into two per-parity
        FrameDatas, each reconstructs as a half-height picture, and the
        fields weave back into the frame."""
        import dataclasses
        sps, deblock, ab_offset, weights, pps = fd.recon_ctx
        hsps = dataclasses.replace(sps, mb_height=sps.mb_height // 2)
        nmb = sps.mb_width * sps.mb_height
        n2 = nmb // 2
        mbh = sps.mb_height
        ent = getattr(fd, "dpb_entry", None)
        if ent is not None and ent.field_planes is None:
            ent.field_planes = {}

        def field_list(frames, par, pids):
            # field MBs address the MbaffRefPicList (8.2.4.2.5): frame
            # ref k splits into fields 2k (same parity) / 2k+1
            # (opposite), so the CODED ref_idx indexes this list as-is
            views, vpids = [], []
            for k, e in enumerate(frames or []):
                for vp in (par, 1 - par):
                    fv = DPBEntry(e.poc, None, frame_num=e.frame_num)
                    fv.field_src = (e, vp)
                    views.append(fv)
                    base = int(pids[k]) if pids is not None and \
                        k < len(pids) else -1
                    vpids.append(-1 if base < 0 else 2 * base + vp)
            return views, np.array(vpids or [-1], np.int8)

        halves = []
        for par in (0, 1):
            sub = FrameData(n2, sps.mb_width, mbh // 2)
            sl = slice(par * n2, (par + 1) * n2)
            for name, v in vars(fd).items():
                if not isinstance(v, np.ndarray) or v.ndim < 1:
                    continue
                if v.shape[0] == nmb:
                    setattr(sub, name, v[sl])
                elif v.shape[0] in (4 * mbh, 2 * mbh):
                    h2 = v.shape[0] // 2
                    setattr(sub, name, v[par * h2:(par + 1) * h2])
            sub.recon_ctx = (hsps, deblock, ab_offset, weights, pps)
            sub.field_info = (0, 0, False)
            sub.mbaff_field = False
            sub.list0, sub.l0pid = field_list(fd.list0, par, fd.l0pid)
            sub.list1, sub.l1pid = field_list(fd.list1, par, fd.l1pid)
            sub.dpb_entry = ent
            sub.dpb_parity = par
            g = fd.grids
            if g is not None and g.bref is not None:
                # per-parity views of the stacked block-motion grids so
                # partitioned MBs reconstruct block-granular too
                sg = part.MotionGrids(sps.mb_width, mbh // 2,
                                      alloc=False)
                r0, r1 = par * (g.bh // 2), (par + 1) * (g.bh // 2)
                sg.bref = g.bref[:, r0:r1]
                sg.bmv = g.bmv[:, r0:r1]
                sg.bmvd = (g.bmvd[:, r0:r1]
                           if g.bmvd is not None else None)
                sg.bdirect = (g.bdirect[r0:r1]
                              if g.bdirect is not None else None)
                sg.slice_id = g.slice_id[par * n2:(par + 1) * n2]
                sg.any_part = g.any_part
                sub.grids = sg
            sub.tdirect = None
            sub.slice_starts = [0]
            halves.append(self._reconstruct(sub, slice_info))
        with timer.timer("h264.weave", src="mbaff"):
            return self._weave_fields(halves[0], halves[1])

    def _finish_au(self, fut, au: int) -> List[Frame]:
        """Reconstruct access unit number `au` once its entropy (`fut`)
        is done."""
        with timer.timer("h264.entropy.wait", au=au):
            fd, slice_info, pkt = fut.result()
        frames = []
        if fd is not None:
            st = slice_info[0]
            finfo = getattr(fd, "field_info", (0, 0, False))
            with timer.timer("h264.recon", au=au,
                             pict="I" if st == SLICE_I else
                             "B" if st == SLICE_B else "P"):
                if getattr(fd, "mbaff_field", False):
                    f = self._recon_mbaff(fd, slice_info)
                elif finfo[0]:
                    with timer.timer("h264.recon.field", par=finfo[1]):
                        f = self._reconstruct(fd, slice_info)
                else:
                    f = self._reconstruct(fd, slice_info)
            f.pts = pkt.pts
            f.time_base = pkt.time_base
            if finfo[0]:
                stash = getattr(self, "_field_out", None)
                if stash is None or stash[1] == finfo[1]:
                    # first field of a pair: hold for weaving
                    self._field_out = (f, finfo[1])
                    return []
                first, fpar = stash
                self._field_out = None
                top, bot = (first, f) if fpar == 0 else (f, first)
                with timer.timer("h264.weave", src="paff"):
                    wf = self._weave_fields(top, bot)
                wf.pts = first.pts if first.pts is not None and \
                    first.pts != NOPTS_VALUE else f.pts
                wf.time_base = f.time_base
                f = wf
            frames.append(f)
        if not self._reorder:
            return frames
        out = []
        for f in frames:
            if f.key_frame:          # IDR: prior pictures output first
                out.extend(self._pop_all())
            if f.pts is not None and f.pts != NOPTS_VALUE:
                self._pts_pool.append(f.pts)
            self._outq.append((getattr(f, "poc", 0), len(self._outq), f))
            while len(self._outq) > self.REORDER_DEPTH:
                self._outq.sort(key=lambda t: (t[0], t[1]))
                out.append(self._restamp(self._outq.pop(0)[2]))
        return out

    def _restamp(self, f: Frame) -> Frame:
        """Output pictures leave in display order, so they take the
        smallest pending input pts (decode.c guess_correct_pts analogue:
        container pts follow presentation order)."""
        if self._pts_pool:
            self._pts_pool.sort()
            f.pts = self._pts_pool.pop(0)
        return f

    def _pop_all(self):
        self._outq.sort(key=lambda t: (t[0], t[1]))
        out = [self._restamp(t[2]) for t in self._outq]
        self._outq = []
        return out

    def _drain(self) -> List[Frame]:
        out = []
        if self._au_fut is not None:
            fut, self._au_fut = self._au_fut, None
            out.extend(self._finish_au(fut, self._au_count - 1))
        out.extend(self._pop_all())
        return out

    def _entropy_nals(self, pkt: Packet, au: int, twin: bool = False):
        """Entropy of one AU; twin: on the twin whatever the slices."""
        with timer.timer("h264.entropy", au=au):
            return self._entropy_nals_timed(pkt, au, twin)

    def _entropy_nals_timed(self, pkt: Packet, au: int, twin: bool):
        nals = nal_mod.split_annexb(pkt.data)
        fd = None
        slice_info = None
        for n in nals:
            ref_idc, ntype = nal_mod.nal_header(n)
            rbsp = nal_mod.unescape(n[1:])
            if ntype == nal_mod.NAL_SPS:
                s = sets.parse_sps(rbsp)
                self.sps[s.sps_id] = s
            elif ntype == nal_mod.NAL_PPS:
                p = sets.parse_pps(rbsp, self.sps)
                self.pps[p.pps_id] = p
            elif ntype in (nal_mod.NAL_SLICE, nal_mod.NAL_IDR):
                try:
                    fd, slice_info = self._decode_slice(
                        rbsp, ntype == nal_mod.NAL_IDR, fd, ref_idc, twin)
                except _NativeUnsupported:
                    raise
                except AVError:
                    # error concealment (reference: error_resilience.c
                    # ff_er_frame_end): keep what decoded, guess the rest
                    fd2 = getattr(self, "_fd_inflight", None)
                    info2 = getattr(self, "_inflight_info", None)
                    if fd2 is None or info2 is None or \
                            not np.any(fd2.coded):
                        raise
                    fd, slice_info = fd2, info2
                    self._conceal(fd, slice_info)
                    break
        if fd is not None and fd.engine == "cabac":
            self._run_cabac_slices(fd, au)
        if fd is not None and fd.engine == "python" and \
                (fd.field_info[0] or fd.mbaff_field):
            # field macroblocks code coefficients in FIELD-scan order
            # (spec 8.5.6; reference h264_cavlc.c:1113) — reorder to the
            # zigzag layout the recon program expects (the native CABAC
            # writes its rows in that layout already)
            from libav_tpu_torch.codecs.h264.cavlc import ZZ_FROM_FIELD
            for arr in (fd.luma_dc, fd.luma_ac, fd.chroma_ac):
                arr[:] = arr[..., ZZ_FROM_FIELD]
        if fd is not None:
            # capture the recon-side context (the worker may already be
            # parsing the NEXT AU's headers when recon runs)
            fd.recon_ctx = (self.active_sps, self._deblock,
                            self._ab_offset,
                            getattr(self, "_weights", None),
                            self.active_pps)
            st_, idr_, poc_, ridc_ = slice_info
            # per-block picture ids for the deblock bS rule, from the
            # DPB as seen by THIS frame (before its own entry)
            pid_of = {id(e): k for k, e in enumerate(self._dpb)}

            def pid(e):
                if e.field_src is not None:  # field views: unique per
                    src, par = e.field_src   # (frame, parity)
                    base = pid_of.get(id(src), -1)
                    return -1 if base < 0 else 2 * base + par
                return pid_of.get(id(e), -1)
            fd.l0pid = np.array([pid(e) for e in (fd.list0 or [])]
                                or [-1], np.int8)
            fd.l1pid = np.array([pid(e) for e in (fd.list1 or [])]
                                or [-1], np.int8)
            fd.dpb_entry = None
            fd.dpb_parity = None
            finfo = getattr(fd, "field_info", (0, 0, False))
            if ridc_ and finfo[0] and finfo[2]:
                # second field completes the pending frame entry
                # (8.2.5.1: one DPB frame per complementary pair)
                ent = self._incomplete_field[0]
                ent.field_poc[finfo[1]] = poc_ if poc_ is not None else 0
                ent.poc = min(ent.field_poc.values())
                self._incomplete_field = None
                self._prev_frame_num = ent.frame_num
                fd.dpb_entry = ent
                fd.dpb_parity = finfo[1]
            elif ridc_:
                ent = DPBEntry(poc_ if poc_ is not None else 0, None,
                               self._col_motion(fd),
                               frame_num=getattr(self, "_frame_num", 0))
                if finfo[0]:
                    ent.field_poc = {finfo[1]: ent.poc}
                    ent.field_planes = {}
                    ent.colref = ent.colmv = ent.colpoc = None
                    ent.colpacked = None
                    self._incomplete_field = (ent, finfo[1],
                                              ent.frame_num)
                    fd.dpb_parity = finfo[1]
                pend = getattr(self, "_pending_mmco", None)
                adaptive = pend is not None
                if pend:
                    self._exec_mmco(pend, ent.frame_num, self.active_sps)
                self._pending_mmco = None
                max_refs = max(1, self.active_sps.max_num_ref_frames)
                mark = getattr(self, "_mark_lt", None)
                shorts = [e for e in self._dpb if not e.long_term]
                longs = [e for e in self._dpb if e.long_term]
                # capacity: the sliding window (8.2.5.3) runs only
                # WITHOUT adaptive marking; with MMCO present a
                # conforming op list keeps the count bounded, and
                # overflow is corrupt-stream recovery (reference
                # h264_refs.c:707 discards with the same tolerance)
                if mark is not None:       # MMCO 6 / IDR long_term flag
                    ent.long_term = True
                    ent.lt_idx = mark
                    longs = [ent] + [e for e in longs
                                     if e.lt_idx != mark]
                    while len(shorts) + len(longs) - 1 > max_refs \
                            and shorts:
                        shorts.pop()       # oldest short-term
                    self._dpb = shorts + longs
                else:
                    lim = max_refs + (1 if adaptive else 0)
                    while len(shorts) + len(longs) + 1 > lim and shorts:
                        shorts.pop()
                    self._dpb = [ent] + shorts + longs
                self._prev_frame_num = ent.frame_num
                fd.dpb_entry = ent
        return fd, slice_info

    def _conceal(self, fd, slice_info):
        """Fill undecoded MBs (reference: error_resilience.c:52
        guess_mv / is_intra_more_likely simplified): inter frames get a
        guessed MV (average of decoded neighbors, ref 0, no residual);
        intra frames get DC-predicted I_16x16 (spatial interpolation by
        the normal wavefront intra path)."""
        sps = self.active_sps
        mb_w, mb_h = sps.mb_width, sps.mb_height
        slice_type = slice_info[0]
        temporal = slice_type != SLICE_I and bool(self._dpb)
        g = fd.grids
        coded = fd.coded.astype(bool).copy()
        n_bad = 0
        for i in range(mb_w * mb_h):
            if coded[i]:
                continue
            n_bad += 1
            mb_x, mb_y = i % mb_w, i // mb_w
            if temporal:
                cands = []
                for nx, ny in ((mb_x - 1, mb_y), (mb_x, mb_y - 1),
                               (mb_x + 1, mb_y), (mb_x, mb_y + 1)):
                    if 0 <= nx < mb_w and 0 <= ny < mb_h:
                        j = ny * mb_w + nx
                        if coded[j] and not fd.intra[j]:
                            cands.append(np.asarray(fd.mv[j]))
                mv = (tuple(int(round(v)) for v in
                            np.mean(cands, axis=0)) if cands else (0, 0))
                fd.intra[i] = 0
                fd.mv[i] = mv
                fd.ref_idx[i] = 0
                if g is not None:
                    g.slice_id[i] = 0
                    g.set_part(0, 4 * mb_x, 4 * mb_y, 4, 4, 0, mv)
                    g.set_unused(1, 4 * mb_x, 4 * mb_y, 4, 4)
            else:
                fd.intra[i] = 1
                fd.i4[i] = 0
                fd.luma_mode[i] = 2            # DC prediction
                fd.chroma_mode[i] = 0
                fd.luma_dc[i] = 0
                if g is not None:
                    g.slice_id[i] = 0
                    g.set_intra(mb_x, mb_y)
            fd.qp[i] = 26
            fd.luma_ac[i] = 0
            fd.chroma_ac[i] = 0
            fd.chroma_dc[i] = 0
            fd.coded[i] = True
        if n_bad:
            log.warning("h264", f"concealing {n_bad} macroblocks")

    # ------------------------------------------------------------------ #

    def _decode_slice(self, rbsp: bytes, idr: bool, fd, ref_idc: int = 1,
                      twin: bool = False):
        gb = GetBits(rbsp)
        first_mb = gb.get_ue_golomb()
        slice_type = gb.get_ue_golomb() % 5
        if slice_type not in (SLICE_P, SLICE_B, SLICE_I):
            raise AVError(INVALIDDATA, f"slice type {slice_type} not supported yet")
        pps_id = gb.get_ue_golomb()
        pps = self.pps.get(pps_id)
        if pps is None:
            raise AVError(INVALIDDATA, f"unknown PPS {pps_id}")
        sps = self.sps.get(pps.sps_id)
        if sps is None:
            raise AVError(INVALIDDATA, f"unknown SPS {pps.sps_id}")
        self.active_sps, self.active_pps = sps, pps
        self.width, self.height = sps.width, sps.height

        frame_num = gb.get_bits(sps.log2_max_frame_num)
        self._frame_num = frame_num
        # PAFF field pictures (spec 7.3.3 field_pic_flag; reference
        # h264_slice.c picture_structure): each field decodes as a
        # half-height picture; references are fields of DPB frames
        field_pic = bottom = 0
        if not sps.frame_mbs_only:
            field_pic = gb.get_bits(1)
            if field_pic:
                bottom = gb.get_bits(1)
        if field_pic:
            if any(sps.crop):
                raise AVError(INVALIDDATA,
                              "field pictures with cropping unsupported")
            import dataclasses
            sps = dataclasses.replace(sps, mb_height=sps.mb_height // 2)
            self.active_sps = sps
        self._cur_mbaff = bool(sps.mb_aff and not field_pic)
        pend_f = getattr(self, "_incomplete_field", None)
        is_second = bool(field_pic and pend_f is not None and
                         pend_f[2] == frame_num and pend_f[1] != bottom)
        self._cur_field = (field_pic, bottom, is_second)
        if not idr:
            # gaps_in_frame_num (spec 8.2.5.2; reference
            # h264_slice.c:1404): insert "non-existing" short-term
            # frames for the skipped frame_num values — each carries a
            # copy of the newest reference (error-concealment rule,
            # :1425) and takes poc + 2
            max_fn = 1 << sps.log2_max_frame_num
            prev = getattr(self, "_prev_frame_num", frame_num)
            if frame_num != prev and frame_num != (prev + 1) % max_fn:
                up = prev if prev <= frame_num else prev - max_fn
                if frame_num - up > sps.max_num_ref_frames:
                    # shorten oversized gaps (reference :1335)
                    up = frame_num - sps.max_num_ref_frames - 1
                cur = up
                while (cur + 1) % max_fn != frame_num:
                    cur = (cur + 1) % max_fn
                    newest = next((e for e in self._dpb
                                   if not e.long_term), None)
                    ent = DPBEntry(
                        (newest.poc + 2) if newest else 0,
                        newest.planes if newest else None,
                        newest.colpacked if newest else None,
                        frame_num=cur)
                    ent.src = newest   # pixels may be filled in later
                    shorts = [e for e in self._dpb if not e.long_term]
                    longs = [e for e in self._dpb if e.long_term]
                    mr = max(1, sps.max_num_ref_frames)
                    while len(shorts) + len(longs) + 1 > mr and shorts:
                        shorts.pop()
                    self._dpb = [ent] + shorts + longs
                self._prev_frame_num = (frame_num - 1) % max_fn
        if idr:
            gb.get_ue_golomb()                   # idr_pic_id
        poc = None
        if sps.poc_type == 0:
            poc_lsb = gb.get_bits(sps.log2_max_poc_lsb)
            # PicOrderCntMsb derivation with wrap (spec 8.2.1.1)
            if idr:
                self._poc_state = (0, 0)
                prev_msb, prev_lsb = 0, 0
            else:
                prev_msb, prev_lsb = self._poc_state
            max_lsb = 1 << sps.log2_max_poc_lsb
            if poc_lsb < prev_lsb and prev_lsb - poc_lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif poc_lsb > prev_lsb and poc_lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            poc = msb + poc_lsb
            if pps.pic_order_present and not field_pic:
                dbot = gb.get_se_golomb()  # delta_pic_order_cnt_bottom
                if dbot < 0:
                    poc += dbot            # PicOrderCnt = Min(tf, bf)
            if ref_idc:
                self._poc_state = (msb, poc_lsb)
            self._reorder = True
        else:
            # FrameNumOffset with frame_num wrap (8.2.1.2 / 8.2.1.3)
            max_fn = 1 << sps.log2_max_frame_num
            if idr:
                fno = 0
            else:
                pfn, pfno = getattr(self, "_fno_state", (0, 0))
                fno = pfno + max_fn if frame_num < pfn else pfno
            self._fno_state = (frame_num, fno)
            if sps.poc_type == 1:
                d0 = d1 = 0
                if not sps.delta_pic_order_always_zero:
                    d0 = gb.get_se_golomb()
                    if pps.pic_order_present:
                        d1 = gb.get_se_golomb()
                offs = sps.offset_for_ref_frame
                ncyc = len(offs)
                abs_fn = (fno + frame_num) if ncyc else 0
                if ref_idc == 0 and abs_fn > 0:
                    abs_fn -= 1
                expected = 0
                if abs_fn > 0:
                    cyc, in_cyc = divmod(abs_fn - 1, ncyc)
                    expected = cyc * sum(offs) + sum(offs[:in_cyc + 1])
                if ref_idc == 0:
                    expected += sps.offset_for_non_ref_pic
                tf = expected + d0
                bf = tf + sps.offset_for_top_to_bottom + d1
                poc = min(tf, bf)
                self._reorder = True
            else:                          # poc_type 2 (8.2.1.3)
                poc = 2 * (fno + frame_num) - (0 if ref_idc else 1)
                self._reorder = False
        # default reference picture lists (spec 8.2.4.2): P list0 in
        # decode order (sliding-window DPB order); B list0 = past by POC
        # descending then future ascending, list1 mirrored
        pc = poc if poc is not None else 0
        shorts = [e for e in self._dpb if not e.long_term]
        longs = sorted((e for e in self._dpb if e.long_term),
                       key=lambda e: e.lt_idx)
        if field_pic:
            if slice_type == SLICE_B:
                raise AVError(INVALIDDATA,
                              "B field pictures not supported yet")
            # P field list0 (8.2.4.2.5): frames in decode order, their
            # fields interleaved starting with the current parity; the
            # same frame's first field participates when decoding the
            # second (it sits at _dpb[0] already)
            same, opp = [], []
            for e in shorts:
                fpocs = getattr(e, "field_poc", None)
                if fpocs is None:
                    continue
                for par, tgt in ((bottom, same), (1 - bottom, opp)):
                    if par in fpocs:
                        fv = DPBEntry(fpocs[par], None,
                                      frame_num=e.frame_num)
                        fv.field_src = (e, par)
                        tgt.append(fv)
            list0 = []
            for i in range(max(len(same), len(opp))):
                if i < len(same):
                    list0.append(same[i])
                if i < len(opp):
                    list0.append(opp[i])
            list1 = []
            self._cur_col = None
        elif slice_type == SLICE_B:
            past = sorted((e for e in shorts if e.poc <= pc),
                          key=lambda e: -e.poc)
            futr = sorted((e for e in shorts if e.poc > pc),
                          key=lambda e: e.poc)
            list0 = (past + futr + longs) or list(self._dpb)
            list1 = (futr + past + longs) or list(self._dpb)
            self._cur_col = ((list1[0].colref, list1[0].colmv,
                              list1[0].colpacked)
                             if list1 and list1[0].colref is not None
                             else None)
        else:
            list0, list1 = shorts + longs, []
            self._cur_col = None
        self._cur_lists = (list0, list1)

        num_ref_l0 = pps.num_ref_idx_l0_active
        num_ref_l1 = pps.num_ref_idx_l1_active
        temporal = False
        if slice_type == SLICE_B:
            self._direct_spatial = bool(gb.get_bits(1))
            temporal = not self._direct_spatial
        if slice_type in (SLICE_P, SLICE_B):
            if gb.get_bits(1):                   # num_ref_idx_override
                num_ref_l0 = gb.get_ue_golomb() + 1
                if slice_type == SLICE_B:
                    num_ref_l1 = gb.get_ue_golomb() + 1
            # ref_pic_list_modification (spec 7.3.3.1 / 8.2.4.3;
            # reference h264_refs.c ff_h264_decode_ref_pic_list_reordering)
            if gb.get_bits(1):
                if field_pic:
                    raise AVError(INVALIDDATA, "ref list modification "
                                  "on field pictures unsupported")
                list0 = self._modify_ref_list(gb, list0, frame_num, sps)
            if slice_type == SLICE_B:
                list1 = self._modify_ref_list(gb, list1, frame_num, sps) \
                    if gb.get_bits(1) else list1
            self._cur_lists = (list0, list1)
            if slice_type == SLICE_B:
                self._cur_col = ((list1[0].colref, list1[0].colmv,
                                  list1[0].colpacked)
                                 if list1 and list1[0].colref is not None
                                 else None)
        # pred_weight_table (spec 7.3.3.2; reference h264_parse.c
        # ff_h264_pred_weight_table)
        self._weights = None
        if (pps.weighted_pred and slice_type == SLICE_P) or \
                (pps.weighted_bipred_idc == 1 and slice_type == SLICE_B):
            self._weights = self._parse_weight_table(
                gb, num_ref_l0, num_ref_l1 if slice_type == SLICE_B else 0)
        elif pps.weighted_bipred_idc == 2 and slice_type == SLICE_B:
            self._weights = "implicit"
        # dec_ref_pic_marking (only present for reference pictures)
        self._mark_lt = None         # LongTermFrameIdx for the CURRENT pic
        if idr:
            gb.get_bits(1)                       # no_output_of_prior_pics
            if gb.get_bits(1):                   # long_term_reference_flag
                self._mark_lt = 0                # 8.2.5.1: idx 0
            self._dpb = []
            if not is_second:
                self._incomplete_field = None
        elif ref_idc:
            self._pending_mmco = None
            if field_pic and gb.show_bits(1):
                raise AVError(INVALIDDATA,
                              "MMCO on field pictures unsupported")
            if gb.get_bits(1):                   # adaptive marking (MMCO)
                # parsed per slice, EXECUTED once at picture end
                # (reference h264_refs.c: marking after the frame) —
                # every slice of the AU carries the identical op list
                self._pending_mmco = self._parse_mmco(gb)
        cabac_init_idc = 0
        if pps.entropy_coding_mode and slice_type != SLICE_I:
            cabac_init_idc = gb.get_ue_golomb()
            if cabac_init_idc > 2:
                raise AVError(INVALIDDATA, "bad cabac_init_idc")
        qp = pps.pic_init_qp + gb.get_se_golomb()
        disable_deblock = 0
        ab_offset = (0, 0)
        if pps.deblocking_filter_control_present:
            disable_deblock = gb.get_ue_golomb()
            if disable_deblock != 1:
                ab_offset = (gb.get_se_golomb(), gb.get_se_golomb())
        self._deblock = disable_deblock != 1
        # slice alpha_c0/beta offsets are static parameters of the
        # deblock program (spec indexA/indexB; h264_loopfilter.c)
        self._ab_offset = (int(ab_offset[0]), int(ab_offset[1]))

        engine = _engine(bool(pps.entropy_coding_mode), slice_type,
                         bool(field_pic), self._cur_mbaff, temporal, twin)
        if fd is None:
            # the AU's first slice fixes its engine
            fd = self._frame_data(engine, sps)
        elif fd.engine != "python" and engine != fd.engine:
            # a later slice its native engine cannot take
            raise _NativeUnsupported()
        fd.list0, fd.list1 = self._cur_lists
        fd.field_info = self._cur_field
        fd.mbaff_field = self._cur_mbaff
        if fd.mbaff_field and first_mb != 0:
            raise AVError(INVALIDDATA,
                          "MBAFF multi-slice pictures unsupported")
        fd.tdirect = None
        if temporal and fd.list1:
            e1 = fd.list1[0]
            fd.col_poc = e1.poc
            fd.t8_params = (int(pps.transform_8x8_mode),
                            int(sps.direct_8x8_inference))
            fd.tdirect = (poc if poc is not None else 0,
                          tuple(e.poc for e in fd.list0),
                          e1.colref, e1.colmv,
                          e1.colpoc if e1.colpoc is not None else
                          np.zeros_like(e1.colref, np.int32))
        fd.slice_starts.append(first_mb)
        # concealment anchor: on a mid-slice bitstream error the caller
        # recovers the partially decoded frame from here
        self._fd_inflight = fd
        self._inflight_info = (slice_type, idr, poc, ref_idc)
        if fd.engine == "cabac":
            # decoded with the AU's other slices (_run_cabac_slices)
            pos = gb.bits_read()
            fd.t8_params = (int(pps.transform_8x8_mode),
                            int(sps.direct_8x8_inference))
            self._queue_cabac_native(
                rbsp[(pos + 7) >> 3:], fd, first_mb, slice_type, qp,
                num_ref_l0, num_ref_l1, cabac_init_idc)
        elif pps.entropy_coding_mode:
            pos = gb.bits_read()
            data = rbsp[(pos + 7) >> 3:]     # cabac_alignment_one_bit
            with timer.timer("h264.entropy.slice", path="python"):
                self._decode_mbs_cabac(data, fd, sps, first_mb,
                                       slice_type, qp, num_ref_l0,
                                       cabac_init_idc,
                                       num_ref_l1=num_ref_l1)
        elif fd.engine == "cavlc":
            from libav_tpu_torch.native import h264_cavlc as N
            pos = gb.bits_read()
            with timer.timer("h264.entropy.slice", path="native"):
                rc = N.decode_slice(fd.block, rbsp[pos >> 3:],
                                    sps.mb_width, sps.mb_height, first_mb,
                                    slice_type, qp, bit_offset=pos & 7,
                                    sparse=fd.sparse, num_ref=num_ref_l0,
                                    ref_idx=fd.ref_idx)
            if rc != 0:
                # -3: outside the C subset; otherwise a corrupt stream,
                # which the twin conceals (it tracks per-MB progress)
                raise _NativeUnsupported()
        else:
            cur_slice = fd.nslices
            fd.nslices += 1
            with timer.timer("h264.entropy.slice", path="python"):
                self._decode_mbs(gb, fd, sps, first_mb, slice_type, qp,
                                 num_ref_l0, num_ref_l1, cur_slice)
        return fd, (slice_type, idr, poc, ref_idc)

    # ------------------------------------------------------------------ #

    @staticmethod
    def _apply_dqp(qp: int, delta: int) -> int:
        qp += delta
        if qp < 0:
            qp += 52
        elif qp > 51:
            qp -= 52
        return qp

    # -- partition-aware inter prediction: the walk itself lives in
    #    part.code_inter_mb and is shared verbatim with the encoder ---- #

    def _decode_inter_mb(self, rd, fd, i, mb_x, mb_y, slice_type, mb_type,
                         nref0, nref1, cur_slice):
        return part.code_inter_mb(rd, fd, i, mb_x, mb_y,
                                  slice_type == SLICE_B, mb_type, nref0,
                                  nref1, cur_slice, self._cur_col)

    def _frame_data(self, engine: str, sps) -> FrameData:
        """A FrameData for one AU on `engine`. The native engines' storage
        ping-pongs between two buffers of a pool (_fd_pool for cavlc,
        _cabac_pool for cabac), so that the recon of AU N (the caller's
        thread) never shares storage with the entropy of AU N+1 (the
        worker thread)."""
        mb_w, mb_h = sps.mb_width, sps.mb_height
        nmb = mb_w * mb_h
        if engine == "cavlc":
            pool = getattr(self, "_fd_pool", None)
            if pool is None or pool[0] != nmb:
                fd = FrameData(nmb, mb_w, mb_h, engine)
                self._fd_pool = (nmb, fd, FrameData(nmb, mb_w, mb_h, engine))
                self._pool_idx = 0
                return fd
            self._pool_idx = 1 - self._pool_idx
            fd = pool[1 + self._pool_idx]
            fd.intra[:] = 0
            fd.coded[:] = 0
            fd.ref_idx[:] = 0
            fd.sparse[2][0] = 0
            fd.sparse[2][1] = 0
            fd.grids.reset()
            fd.nslices = 0
            fd.slice_starts = []
            fd.ipcm = None
            return fd
        fd = FrameData(nmb, mb_w, mb_h, engine)
        if engine != "cabac":
            return fd
        from libav_tpu_torch.native import h264_cabac_host as CN
        pool = getattr(self, "_cabac_pool", None)
        if pool is None or pool[0] != nmb:
            pool = (nmb, CN.alloc(nmb), CN.alloc(nmb))
            self._cabac_pool = pool
            self._cabac_idx = 0
        self._cabac_idx = 1 - getattr(self, "_cabac_idx", 1)
        arena, coeffs = pool[1 + self._cabac_idx]
        v = CN.views(arena, coeffs, nmb, mb_w, mb_h)
        # arena reset happens in _run_cabac_slices (native-side in the
        # serial path, numpy-side before parallel dispatch)
        fd.cabac_native = (arena, coeffs, v)
        fd.pending_slices = []
        for name in ("intra", "i4", "i4_modes", "luma_mode", "chroma_mode",
                     "qp", "coded", "mv", "ref_idx", "sel", "luma_dc",
                     "chroma_dc", "nnz_y", "nnz_u", "nnz_v", "transform8"):
            setattr(fd, name, v[name])
        fd.sparse = (v["yvals"], v["cvals"], v["sctx"])
        g = fd.grids
        g.bref = v["bref"]
        g.bmv = v["bmv"]
        g.bmvd = v["bmvd"]
        g.bdirect = v["bdirect"]
        g.slice_id = v["gslice"]
        return fd

    _slice_exec = None

    def _queue_cabac_native(self, data, fd, first_mb, slice_type, qp,
                            nref0, nref1, cabac_init_idc):
        """Native C CABAC path: slices are queued and executed at AU end
        — in parallel threads when the frame has several slices (slice
        threading; the C layer releases the GIL)."""
        col = None
        if slice_type == SLICE_B and self._cur_col is not None:
            # the DPB entry's packed (ref,mvx,mvy,poc) grid is already
            # the layout the C spatial-direct reader consumes
            col = self._cur_col[2]
            if col is None:
                cref, cmv = self._cur_col[0], self._cur_col[1]
                col = np.empty((cref.shape[0], cref.shape[1], 4),
                               dtype=np.int32)
                col[..., 0] = cref
                col[..., 1:3] = cmv
                col[..., 3] = 0
        fd.pending_slices.append(
            (data, first_mb, slice_type, qp, cabac_init_idc,
             max(nref0, 1), max(nref1, 1), len(fd.pending_slices), col))

    def _run_cabac_slices(self, fd, au: int):
        """Execute the queued native slice jobs for access unit `au` and
        merge the per-slice sparse coefficient lists (reference: the
        slice threading of pthread_slice.c, applied to the host entropy
        stage)."""
        from libav_tpu_torch.native import h264_cabac_host as CN
        arena, coeffs, v = fd.cabac_native
        jobs = fd.pending_slices
        fd.pending_slices = []
        sps = self.active_sps
        mb_w, mb_h = sps.mb_width, sps.mb_height
        nmb = mb_w * mb_h
        # one host core: a thread pool only adds contention (the GIL is
        # released but there is nothing to run on) — decode serially
        # straight into the shared arena/global sparse lists, which also
        # skips the private-buffer merge below
        serial = len(jobs) == 1 or (os.cpu_count() or 1) <= 1
        t8m, d8i = getattr(fd, "t8_params", (0, 1))
        # a field picture's slices take the field context bank and scan;
        # frame slices pass no flag, so their calls stay the JAX
        # package's (tools/replay_entropy.py captures and compares them)
        fkw = {"field": 1} if fd.field_info[0] else {}
        if serial:
            rcs = []
            for d, fmb, st_, qp, idc, n0, n1, cs, col in jobs:
                with timer.timer("h264.entropy.slice", au=au,
                                 path="native"):
                    rcs.append(CN.decode_slice(
                        arena, coeffs, d, mb_w, mb_h, fmb, st_, qp, idc,
                        n0, n1, cs, cs == 0, col=col, t8mode=t8m,
                        d8x8inf=d8i, **fkw))
        else:
            CN.reset_arena(v)
            bounds = [j[1] for j in jobs] + [nmb]

            def run(k):
                d, fmb, st_, qp, idc, n0, n1, cs, col = jobs[k]
                nsl = max(bounds[k + 1] - bounds[k], 1)
                ycap = nsl * 16
                # np.empty: the C decoder initializes every row/index it
                # publishes (counts in sc[0..1])
                sc = np.empty(2 + ycap + nsl * 8, np.int32)
                cf = np.empty((ycap + nsl * 8) * 16, np.int16)
                with timer.timer("h264.entropy.slice", au=au,
                                 path="native"):
                    rc = CN.decode_slice(arena, cf, d, mb_w, mb_h, fmb,
                                         st_, qp, idc, n0, n1, cs, False,
                                         col=col, sctx=sc, ycap=ycap,
                                         t8mode=t8m, d8x8inf=d8i, **fkw)
                return rc, sc, cf, ycap, nsl
            if self._slice_exec is None:
                import concurrent.futures as _cf
                H264Decoder._slice_exec = _cf.ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="h264-slice")
            res = list(self._slice_exec.map(run, range(len(jobs))))
            rcs = [r[0] for r in res]
            sctx_m = v["sctx"]
            yv, cv = v["yvals"], v["cvals"]
            ny = nc = 0
            for rc, sc, cf, ycap, nsl in res:
                k1, k2 = int(sc[0]), int(sc[1])
                yv[ny:ny + k1] = cf[:ycap * 16].reshape(ycap, 16)[:k1]
                sctx_m[2 + ny:2 + ny + k1] = sc[2:2 + k1]
                cv[nc:nc + k2] = cf[ycap * 16:].reshape(nsl * 8, 16)[:k2]
                sctx_m[2 + 16 * nmb + nc:2 + 16 * nmb + nc + k2] = \
                    sc[2 + ycap:2 + ycap + k2]
                ny += k1
                nc += k2
            sctx_m[0] = ny
            sctx_m[1] = nc
        for rc in rcs:
            if rc == -3:
                raise _NativeUnsupported()
            if rc != 0:
                raise AVError(INVALIDDATA, f"native CABAC failed ({rc})")
        fd.grids.any_part = bool(v["flags"][0]) or \
            any(j[2] == SLICE_B for j in jobs)

    def _decode_mbs_cabac(self, data, fd: FrameData, sps, first_mb,
                          slice_type, qp, num_ref_l0, cabac_init_idc,
                          num_ref_l1=0):
        """CABAC slice data (reference: h264_cabac.c
        ff_h264_decode_mb_cabac :1908, driven through the symmetric bin
        layer in cabac.py — the encoder runs the identical code path)."""
        from libav_tpu_torch.codecs.h264 import cabac as cb
        mb_w, mb_h = sps.mb_width, sps.mb_height
        nmb = mb_w * mb_h
        if getattr(fd, "mbaff_field", False):
            # field MBs address the doubled MbaffRefPicList (7.4.5.1)
            num_ref_l0 *= 2
            num_ref_l1 *= 2
        mc = getattr(fd, "cabac_mc", None)
        if mc is None:
            mc = cb.MbCtx(mb_w, mb_h)
            fd.cabac_mc = mc
            fd.cabac_slices = 0
            fd.nnz_y = mc.nnz_y       # shared with deblock bS derivation
            fd.nnz_u = mc.nnz_u
            fd.nnz_v = mc.nnz_v
        cur_slice = fd.cabac_slices
        fd.cabac_slices += 1
        states = cb.init_states(slice_type == SLICE_I, cabac_init_idc, qp)
        eng = cb.CabacDecoder(data, states)
        mbaff = bool(getattr(fd, "mbaff_field", False))
        layer = cb.CabacMbLayer(eng, mc,
                                {SLICE_I: 2, SLICE_B: 1}.get(slice_type, 0),
                                cur_slice, grids=fd.grids,
                                field=bool(getattr(fd, "field_info",
                                                   (0,))[0]) or mbaff)
        blkx = [b[0] for b in _BLK_XY]
        blky = [b[1] for b in _BLK_XY]

        pps_t8 = bool(self.active_pps is not None
                      and self.active_pps.transform_8x8_mode)
        d8i = bool(sps.direct_8x8_inference)
        scan8 = sets.SCAN8

        def luma_resid(i, mb_x, mb_y, cbp_luma, cat):
            for b in range(16):
                gx, gy = 4 * mb_x + blkx[b], 4 * mb_y + blky[b]
                if cbp_luma & (1 << (b >> 2)):
                    if cat == 1:
                        lv = fd.luma_ac[i, b, 1:16]
                        mx = 15
                    else:
                        lv = fd.luma_ac[i, b, :]
                        mx = 16
                    nnz = layer.residual(i, cat, b, lv, mx)
                else:
                    nnz = 0
                mc.nnz_y[gy, gx] = nnz

        def luma8_resid(i, mb_x, mb_y, cbp_luma):
            """8x8 transform residual: one cat-5 block per coded
            quadrant, de-zigzagged to raster rows 4b..4b+3 of luma_ac
            (the transport layout the device t8 path reshapes)."""
            for b in range(4):
                if cbp_luma & (1 << b):
                    lv = np.zeros(64, np.int32)
                    nnz = layer.residual8(lv)
                    raster = np.zeros(64, np.int32)
                    raster[scan8] = lv
                    fd.luma_ac[i, 4 * b:4 * b + 4, :] = \
                        raster.reshape(4, 16)
                else:
                    nnz = 0
                gx = 4 * mb_x + 2 * (b & 1)
                gy = 4 * mb_y + 2 * (b >> 1)
                mc.nnz_y[gy:gy + 2, gx:gx + 2] = nnz

        def chroma_resid(i, mb_x, mb_y, cbp_chroma):
            if cbp_chroma:
                for c in range(2):
                    layer.residual(i, 3, c, fd.chroma_dc[i, c], 4)
            for c, grid in ((0, mc.nnz_u), (1, mc.nnz_v)):
                for b in range(4):
                    gx = 2 * mb_x + (b & 1)
                    gy = 2 * mb_y + (b >> 1)
                    if cbp_chroma == 2:
                        nnz = layer.residual(i, 4, 4 * c + b,
                                             fd.chroma_ac[i, 4 * c + b,
                                                          1:16], 15)
                    else:
                        nnz = 0
                    grid[gy, gx] = nnz

        def decode_intra(i, mb_x, mb_y, cur_qp):
            mc.intra[i] = True
            kind, cbp_l, cbp_c, mode = layer.mb_type_intra(i)
            fd.intra[i] = True
            fd.grids.set_intra(mb_x, mb_y)
            if kind == 2:                          # I_PCM
                raw = layer.pcm_samples(i)
                if len(raw) < 384:
                    raise AVError(INVALIDDATA, "truncated I_PCM samples")
                self._ipcm_mb(fd, i, mb_x, mb_y, raw)
                return cur_qp
            if kind == 0:                          # I_NxN
                fd.i4[i] = True
                grid = fd.i4_grid
                t8 = False
                if pps_t8:
                    t8 = bool(layer.transform_size_8x8(i))
                    mc.transform8[i] = t8
                    fd.transform8[i] = t8

                def cell(gx_, gy_):
                    if gx_ < 0 or gy_ < 0:
                        return -1
                    mbn = (gy_ >> 2) * mb_w + (gx_ >> 2)
                    if mc.slice_id[mbn] != cur_slice:
                        return -1          # other slice (6.4.9)
                    return int(grid[gy_, gx_])

                if t8:                     # I_8x8: 4 quadrant modes
                    for b in range(4):
                        gx = 4 * mb_x + 2 * (b & 1)
                        gy = 4 * mb_y + 2 * (b >> 1)
                        m_ = min(cell(gx - 1, gy), cell(gx, gy - 1))
                        pm = 2 if m_ < 0 else m_
                        m8 = layer.intra4x4_pred_mode(pm)
                        fd.i4_modes[i, 4 * b:4 * b + 4] = m8
                        grid[gy:gy + 2, gx:gx + 2] = m8
                else:
                    for b in range(16):
                        dx, dy = _BLK_XY[b]
                        gx, gy = 4 * mb_x + dx, 4 * mb_y + dy
                        m_ = min(cell(gx - 1, gy), cell(gx, gy - 1))
                        pm = 2 if m_ < 0 else m_
                        m4 = layer.intra4x4_pred_mode(pm)
                        fd.i4_modes[i, b] = m4
                        grid[gy, gx] = m4
                cm = layer.intra_chroma_pred_mode(i)
                fd.chroma_mode[i] = cm
                mc.chroma_mode[i] = cm
                cbp = layer.cbp(i)
                mc.cbp[i] = cbp
                if cbp:
                    cur_qp = self._apply_dqp(cur_qp, layer.mb_qp_delta())
                else:
                    layer.last_dqp = 0
                fd.qp[i] = cur_qp
                fd.coded[i] = True
                if t8:
                    luma8_resid(i, mb_x, mb_y, cbp & 15)
                else:
                    luma_resid(i, mb_x, mb_y, cbp & 15, cat=2)
                chroma_resid(i, mb_x, mb_y, cbp >> 4)
                return cur_qp
            mc.intra16[i] = True
            fd.luma_mode[i] = mode
            fd.i4_grid[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 2
            cm = layer.intra_chroma_pred_mode(i)
            fd.chroma_mode[i] = cm
            mc.chroma_mode[i] = cm
            mc.cbp[i] = cbp_l | (cbp_c << 4)
            cur_qp = self._apply_dqp(cur_qp, layer.mb_qp_delta())
            fd.qp[i] = cur_qp
            layer.residual(i, 0, 0, fd.luma_dc[i], 16)
            fd.coded[i] = True
            luma_resid(i, mb_x, mb_y, cbp_l, cat=1)
            chroma_resid(i, mb_x, mb_y, cbp_c)
            return cur_qp

        def decode_inter(i, mb_x, mb_y, mb_type, cur_qp):
            subs = self._decode_inter_mb(layer, fd, i, mb_x, mb_y,
                                         slice_type, mb_type, num_ref_l0,
                                         num_ref_l1, cur_slice)
            cbp = layer.cbp(i)
            mc.cbp[i] = cbp
            t8 = False
            if pps_t8 and (cbp & 15) and part.t8_inter_allowed(
                    slice_type == SLICE_B, mb_type, subs, d8i):
                t8 = bool(layer.transform_size_8x8(i))
                mc.transform8[i] = t8
                fd.transform8[i] = t8
            if cbp:
                cur_qp = self._apply_dqp(cur_qp, layer.mb_qp_delta())
            else:
                layer.last_dqp = 0
            fd.qp[i] = cur_qp
            fd.coded[i] = True
            fd.i4_grid[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 2
            if t8:
                luma8_resid(i, mb_x, mb_y, cbp & 15)
            else:
                luma_resid(i, mb_x, mb_y, cbp & 15, cat=2)
            chroma_resid(i, mb_x, mb_y, cbp >> 4)
            return cur_qp

        g = fd.grids
        mbaff_walk = None
        if mbaff:
            # all-field MB pairs over the STACKED field layout (virtual
            # rows 0..H/2-1 = top field image); see the encoder's
            # _pack_mbs_cabac mbaff walk for the topology argument
            nmb2 = nmb // 2
            mbaff_walk = []
            for py in range(mb_h // 2):
                for x_ in range(mb_w):
                    mbaff_walk.append(py * mb_w + x_)
                    mbaff_walk.append(nmb2 + py * mb_w + x_)
        def read_fflag(step):
            # mb_field_decoding_flag: ctx 70 + left/above PAIR condition
            pidx = step // 2
            inc = (1 if pidx % mb_w > 0 else 0) + \
                  (1 if pidx // mb_w > 0 else 0)
            if layer.mb_field_flag(inc) != 1:
                raise AVError(INVALIDDATA,
                              "MBAFF frame-coded pairs unsupported")

        step = 0
        pair_flag_pending = False
        i = first_mb
        while i < nmb:
            if mbaff_walk is not None:
                i = mbaff_walk[step]
                if step % 2 == 0:
                    if slice_type == SLICE_I:
                        read_fflag(step)
                    else:
                        # P/B slice_data: mb_skip_flag first; the field
                        # flag rides the pair's first non-skipped MB
                        # (7.3.4); all-skipped pairs infer it (7.4.4) —
                        # our all-field topology needs the inference to
                        # land on 1, which left/above field pairs give
                        pair_flag_pending = True
            mb_x, mb_y = i % mb_w, i // mb_w
            mc.slice_id[i] = cur_slice
            g.slice_id[i] = cur_slice
            if slice_type == SLICE_B:
                if layer.mb_skip(i):
                    self._skip_mb(fd, i, mb_x, mb_y, qp, cur_slice, True)
                    mc.skip[i] = True
                    mc.direct[i] = True
                    layer.last_dqp = 0
                else:
                    if pair_flag_pending:
                        read_fflag(step)
                        pair_flag_pending = False
                    btype = layer.mb_type_b(i)
                    if btype == 23:
                        qp = decode_intra(i, mb_x, mb_y, qp)
                    else:
                        mc.direct[i] = btype == 0
                        qp = decode_inter(i, mb_x, mb_y, btype, qp)
            elif slice_type == SLICE_P:
                if layer.mb_skip(i):
                    self._skip_mb(fd, i, mb_x, mb_y, qp, cur_slice, False)
                    mc.skip[i] = True
                    layer.last_dqp = 0
                else:
                    if pair_flag_pending:
                        read_fflag(step)
                        pair_flag_pending = False
                    if layer.mb_type_p_is_intra():
                        qp = decode_intra(i, mb_x, mb_y, qp)
                    else:
                        qp = decode_inter(i, mb_x, mb_y,
                                          layer.mb_type_p_inter(), qp)
            else:
                qp = decode_intra(i, mb_x, mb_y, qp)
            step += 1
            if mbaff_walk is not None:
                if step % 2 == 0 and pair_flag_pending:
                    # both MBs skipped: inferred flag (7.4.4) — all our
                    # neighbors are field pairs, so the inference is 1
                    # (all-field); nothing to read
                    pair_flag_pending = False
                if step >= len(mbaff_walk):
                    break
                # end_of_slice only after the pair's bottom MB
                if step % 2 == 0 and layer.end_of_slice():
                    break
            else:
                i += 1
                if layer.end_of_slice():
                    break

    # ------------------------------------------------------------------ #

    def _nc(self, grid, bx, by):
        # MBAFF stacked layout: the bottom field image's first block row
        # has no 'above' (see the encoder's _nc note)
        cut = getattr(self, "_nc_split", False) and by == grid.shape[0] // 2
        a = grid[by, bx - 1] if bx > 0 else None
        b = grid[by - 1, bx] if by > 0 and not cut else None
        if a is not None and b is not None:
            return (int(a) + int(b) + 1) >> 1
        if a is not None:
            return int(a)
        if b is not None:
            return int(b)
        return 0

    def _skip_mb(self, fd, i, mb_x, mb_y, qp, cur_slice, bslice):
        """P_Skip (8.4.1.1) / B_Skip (spatial direct) macroblock."""
        if bslice:
            part.direct_mb_motion(fd, mb_x, mb_y, cur_slice,
                                  self._cur_col)
        else:
            part.pskip_mb_motion(fd, i, mb_x, mb_y, cur_slice)
        fd.qp[i] = qp
        fd.coded[i] = True
        fd.i4_grid[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 2

    def _ipcm_mb(self, fd, i, mb_x, mb_y, data: bytes):
        """I_PCM bookkeeping shared by the CAVLC and CABAC paths
        (reference h264_cabac.c:2045-2052: all-coded cbp, qscale 0 for
        the loop filter, nnz 16 everywhere, chroma mode 0). The raw
        samples overlay the MB inside the device wavefront."""
        nmb = fd.intra.shape[0]
        if getattr(fd, "ipcm", None) is None:
            fd.ipcm = np.zeros(nmb, bool)
            fd.ipcm_y = np.zeros((nmb, 16, 16), np.uint8)
            fd.ipcm_u = np.zeros((nmb, 8, 8), np.uint8)
            fd.ipcm_v = np.zeros((nmb, 8, 8), np.uint8)
        a = np.frombuffer(data, np.uint8)
        fd.ipcm[i] = True
        fd.ipcm_y[i] = a[:256].reshape(16, 16)
        fd.ipcm_u[i] = a[256:320].reshape(8, 8)
        fd.ipcm_v[i] = a[320:384].reshape(8, 8)
        fd.intra[i] = True
        fd.grids.set_intra(mb_x, mb_y)
        fd.luma_mode[i] = 2
        fd.chroma_mode[i] = 0
        fd.qp[i] = 0                    # deblock quantiser (spec 8.7)
        fd.luma_dc[i] = 0
        fd.luma_ac[i] = 0
        fd.chroma_dc[i] = 0
        fd.chroma_ac[i] = 0
        fd.i4_grid[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 2
        fd.nnz_y[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 16
        fd.nnz_u[2 * mb_y:2 * mb_y + 2, 2 * mb_x:2 * mb_x + 2] = 16
        fd.nnz_v[2 * mb_y:2 * mb_y + 2, 2 * mb_x:2 * mb_x + 2] = 16
        fd.coded[i] = True

    def _decode_mbs(self, gb, fd: FrameData, sps, first_mb, slice_type,
                    qp, num_ref_l0, num_ref_l1=0, cur_slice=0):
        mb_w = sps.mb_width
        nmb = mb_w * sps.mb_height
        rd = _GolombReader(gb)
        bslice = slice_type == SLICE_B
        if getattr(fd, "mbaff_field", False):
            if slice_type == SLICE_B:
                raise AVError(INVALIDDATA,
                              "MBAFF CAVLC B decode unsupported")
            # field MBs address the doubled MbaffRefPicList (7.4.5.1)
            nref0_f = 2 * num_ref_l0
            mb_h = sps.mb_height
            nmb2 = nmb // 2
            walk = []
            for py_ in range(mb_h // 2):
                for x_ in range(mb_w):
                    walk.append(py_ * mb_w + x_)
                    walk.append(nmb2 + py_ * mb_w + x_)
            self._nc_split = True
            try:
                skip_left = 0
                pair_flag_pending = False
                for step, i in enumerate(walk):
                    if gb.bits_left() <= 0:
                        return
                    if step % 2 == 0:
                        pair_flag_pending = True
                    if slice_type == SLICE_P and skip_left == 0:
                        skip_left = gb.get_ue_golomb()
                    if skip_left > 0:
                        skip_left -= 1
                        fd.grids.slice_id[i] = cur_slice
                        self._skip_mb(fd, i, i % mb_w, i // mb_w, qp,
                                      cur_slice, False)
                        if step % 2 == 1 and pair_flag_pending:
                            # both MBs skipped: flag inferred (7.4.4) —
                            # all-field neighbors infer 1; nothing read
                            pair_flag_pending = False
                        continue
                    if gb.bits_left() <= 1:
                        return
                    if pair_flag_pending:
                        if not gb.get_bits(1):
                            raise AVError(
                                INVALIDDATA, "MBAFF frame-coded "
                                "pairs unsupported")
                        pair_flag_pending = False
                    mb_type = gb.get_ue_golomb()
                    fd.grids.slice_id[i] = cur_slice
                    qp = self._decode_mb(gb, rd, fd, i, mb_w,
                                         slice_type, mb_type, qp,
                                         nref0_f if slice_type != SLICE_I
                                         else num_ref_l0, num_ref_l1,
                                         cur_slice)
            finally:
                self._nc_split = False
            return
        i = first_mb
        while i < nmb:
            if gb.bits_left() <= 0:
                break
            if slice_type in (SLICE_P, SLICE_B):
                skip_run = gb.get_ue_golomb()
                for _ in range(skip_run):
                    if i >= nmb:
                        break
                    fd.grids.slice_id[i] = cur_slice
                    self._skip_mb(fd, i, i % mb_w, i // mb_w, qp,
                                  cur_slice, bslice)
                    i += 1
                if i >= nmb or gb.bits_left() <= 1:
                    break
            mb_type = gb.get_ue_golomb()
            fd.grids.slice_id[i] = cur_slice
            qp = self._decode_mb(gb, rd, fd, i, mb_w, slice_type, mb_type,
                                 qp, num_ref_l0, num_ref_l1, cur_slice)
            i += 1
            # rbsp stop detection: a single set bit then zeros
            if gb.bits_left() < 8 and (gb.bits_left() <= 0 or
                                       gb.show_bits(gb.bits_left()) ==
                                       (1 << (gb.bits_left() - 1))):
                break

    def _decode_mb(self, gb, rd, fd: FrameData, i, mb_w, slice_type,
                   mb_type, qp, num_ref_l0, num_ref_l1, cur_slice) -> int:
        mb_x, mb_y = i % mb_w, i // mb_w
        if slice_type == SLICE_B:
            if mb_type < 23:
                return self._decode_inter_cavlc(
                    gb, rd, fd, i, mb_x, mb_y, slice_type, mb_type, qp,
                    num_ref_l0, num_ref_l1, cur_slice)
            mb_type -= 23
        elif slice_type == SLICE_P:
            if mb_type < 5:
                return self._decode_inter_cavlc(
                    gb, rd, fd, i, mb_x, mb_y, slice_type, mb_type, qp,
                    num_ref_l0, num_ref_l1, cur_slice)
            mb_type -= 5
        if mb_type == 0:
            return self._decode_i4x4(gb, fd, i, mb_x, mb_y, qp)
        if mb_type == 25:                    # I_PCM (spec 7.3.5)
            gb.align()                       # pcm_alignment_zero_bit
            start = gb.pos >> 3
            raw = bytes(gb.data[start:start + 384])
            if len(raw) < 384:
                raise AVError(INVALIDDATA, "truncated I_PCM samples")
            gb.pos += 384 * 8
            self._ipcm_mb(fd, i, mb_x, mb_y, raw)
            return qp
        m = mb_type - 1
        pred_mode = m % 4
        cbp_chroma = (m // 4) % 3
        cbp_luma = (m // 12) * 15

        fd.intra[i] = True
        fd.grids.set_intra(mb_x, mb_y)
        fd.luma_mode[i] = pred_mode
        fd.chroma_mode[i] = gb.get_ue_golomb()
        qp += gb.get_se_golomb()
        fd.qp[i] = qp
        fd.i4_grid[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 2
        self._residual_i16(gb, fd, i, mb_x, mb_y, cbp_luma, cbp_chroma)
        fd.coded[i] = True
        return qp

    def _decode_inter_cavlc(self, gb, rd, fd, i, mb_x, mb_y, slice_type,
                            mb_type, qp, nref0, nref1, cur_slice) -> int:
        self._decode_inter_mb(rd, fd, i, mb_x, mb_y, slice_type, mb_type,
                              nref0, nref1, cur_slice)
        cbp_code = gb.get_ue_golomb()
        if cbp_code >= 48:
            raise AVError(INVALIDDATA, "bad CBP code")
        cbp = GOLOMB_TO_INTER_CBP[cbp_code]
        if cbp:
            qp = self._apply_dqp(qp, gb.get_se_golomb())
        fd.qp[i] = qp
        fd.i4_grid[4 * mb_y:4 * mb_y + 4, 4 * mb_x:4 * mb_x + 4] = 2
        self._residual_inter(gb, fd, i, mb_x, mb_y, cbp & 15, cbp >> 4)
        fd.coded[i] = True
        if slice_type == SLICE_B and mb_type in (1, 2, 3):
            fd.sel[i] = mb_type - 1
        return qp

    def _decode_i4x4(self, gb, fd, i, mb_x, mb_y, qp) -> int:
        """I_NxN macroblock, CAVLC (spec 7.3.5.1 mb_pred intra4x4)."""
        fd.intra[i] = True
        fd.i4[i] = True
        fd.grids.set_intra(mb_x, mb_y)
        grid = fd.i4_grid
        for b in range(16):
            dx, dy = _BLK_XY[b]
            gx, gy = 4 * mb_x + dx, 4 * mb_y + dy
            pred = pred_i4_mode(grid, gx, gy)
            if gb.get_bits(1):                    # prev_..._pred_mode_flag
                mode = pred
            else:
                rem = gb.get_bits(3)
                mode = rem + (1 if rem >= pred else 0)
            fd.i4_modes[i, b] = mode
            grid[gy, gx] = mode
        fd.chroma_mode[i] = gb.get_ue_golomb()
        cbp_code = gb.get_ue_golomb()
        if cbp_code >= 48:
            raise AVError(INVALIDDATA, "bad CBP code")
        cbp = GOLOMB_TO_INTRA_CBP[cbp_code]
        if cbp:
            qp += gb.get_se_golomb()
        fd.qp[i] = qp
        self._residual_inter(gb, fd, i, mb_x, mb_y, cbp & 15, cbp >> 4)
        fd.coded[i] = True
        return qp

    # -- residuals -------------------------------------------------------#

    def _residual_i16(self, gb, fd, i, mb_x, mb_y, cbp_luma, cbp_chroma):
        nnz = fd.nnz_y
        bx0, by0 = 4 * mb_x, 4 * mb_y
        # luma DC: nC from block 0 context
        nc = self._nc(nnz, bx0, by0)
        dc, _ = cavlc.decode_residual(gb, nc, 16)
        fd.luma_dc[i] = dc
        # luma AC
        for b in range(16):
            dx, dy = _BLK_XY[b]
            if cbp_luma:
                nc = self._nc(nnz, bx0 + dx, by0 + dy)
                lv, tc = cavlc.decode_residual(gb, nc, 15)
                fd.luma_ac[i, b, 1:16] = lv
                nnz[by0 + dy, bx0 + dx] = tc
            else:
                nnz[by0 + dy, bx0 + dx] = 0
        self._residual_chroma(gb, fd, i, mb_x, mb_y, cbp_chroma)

    def _residual_inter(self, gb, fd, i, mb_x, mb_y, cbp_luma, cbp_chroma):
        nnz = fd.nnz_y
        bx0, by0 = 4 * mb_x, 4 * mb_y
        for b in range(16):
            dx, dy = _BLK_XY[b]
            if cbp_luma & (1 << (b >> 2)):
                nc = self._nc(nnz, bx0 + dx, by0 + dy)
                lv, tc = cavlc.decode_residual(gb, nc, 16)
                fd.luma_ac[i, b, :] = lv
                nnz[by0 + dy, bx0 + dx] = tc
            else:
                nnz[by0 + dy, bx0 + dx] = 0
        self._residual_chroma(gb, fd, i, mb_x, mb_y, cbp_chroma)

    def _residual_chroma(self, gb, fd, i, mb_x, mb_y, cbp_chroma):
        if cbp_chroma:
            for c in range(2):
                dc, _ = cavlc.decode_residual(gb, -1, 4)
                fd.chroma_dc[i, c] = dc
        for c, grid in ((0, fd.nnz_u), (1, fd.nnz_v)):
            bx0, by0 = 2 * mb_x, 2 * mb_y
            for b in range(4):
                dx, dy = b & 1, b >> 1
                if cbp_chroma == 2:
                    nc = self._nc(grid, bx0 + dx, by0 + dy)
                    lv, tc = cavlc.decode_residual(gb, nc, 15)
                    fd.chroma_ac[i, 4 * c + b, 1:16] = lv
                    grid[by0 + dy, bx0 + dx] = tc
                else:
                    grid[by0 + dy, bx0 + dx] = 0

    # ------------------------------------------------------------------ #

    @staticmethod
    def _modify_ref_list(gb, lst, frame_num, sps):
        """ref_pic_list_modification, short-term ops (spec 8.2.4.3.1/.2;
        reference h264_refs.c ff_h264_build_ref_list modification loop):
        move the named picture to the next index, shifting the rest."""
        from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
        out = list(lst)
        max_fn = 1 << sps.log2_max_frame_num
        pred = frame_num
        idx = 0
        while True:
            idc = gb.get_ue_golomb()
            if idc == 3:
                break
            if idc == 2:               # long_term_pic_num (8.2.4.3.2)
                ltp = gb.get_ue_golomb()
                target = next((e for e in out
                               if e.long_term and e.lt_idx == ltp), None)
                if target is None:
                    raise AVError(INVALIDDATA,
                                  "ref reorder: long-term pic not in DPB")
                out.remove(target)
                out.insert(min(idx, len(out)), target)
                idx += 1
                continue
            if idc > 2:
                raise AVError(INVALIDDATA, "bad modification_of_pic_nums")
            abs_diff = gb.get_ue_golomb() + 1
            if idc == 0:
                nowrap = pred - abs_diff
                if nowrap < 0:
                    nowrap += max_fn
            else:
                nowrap = pred + abs_diff
                if nowrap >= max_fn:
                    nowrap -= max_fn
            pred = nowrap
            picnum = nowrap - max_fn if nowrap > frame_num else nowrap
            target = None
            for e in out:
                fnw = e.frame_num - max_fn if e.frame_num > frame_num \
                    else e.frame_num
                if fnw == picnum:
                    target = e
                    break
            if target is None:
                raise AVError(INVALIDDATA, "ref reorder: pic not in DPB")
            out.remove(target)
            out.insert(min(idx, len(out)), target)
            idx += 1
        return out

    @staticmethod
    def _parse_mmco(gb):
        """dec_ref_pic_marking adaptive op list (7.3.3.3)."""
        nargs = {1: 1, 2: 1, 3: 2, 4: 1, 5: 0, 6: 1}
        ops = []
        while True:
            op = gb.get_ue_golomb()
            if op == 0:
                return ops
            if op not in nargs:
                raise AVError(INVALIDDATA, f"MMCO op {op} unsupported")
            ops.append((op,) + tuple(gb.get_ue_golomb()
                                     for _ in range(nargs[op])))

    def _exec_mmco(self, ops, frame_num, sps):
        """Execute the marking ops at picture end (spec 8.2.5.4;
        reference h264_refs.c ff_h264_execute_ref_pic_marking)."""
        max_fn = 1 << sps.log2_max_frame_num

        def fnw(e):
            return e.frame_num - max_fn if e.frame_num > frame_num \
                else e.frame_num

        for op in ops:
            if op[0] == 1:             # unmark a short-term picture
                picx = frame_num - (op[1] + 1)
                self._dpb = [e for e in self._dpb
                             if e.long_term or fnw(e) != picx]
            elif op[0] == 2:           # unmark a long-term picture
                self._dpb = [e for e in self._dpb
                             if not (e.long_term and e.lt_idx == op[1])]
            elif op[0] == 3:           # short-term -> LongTermFrameIdx
                picx = frame_num - (op[1] + 1)
                for e in self._dpb:
                    if not e.long_term and fnw(e) == picx:
                        # a picture already holding this idx is
                        # unmarked first (8.2.5.4.3)
                        self._dpb = [x for x in self._dpb
                                     if not (x.long_term and
                                             x.lt_idx == op[2])]
                        e.long_term = True
                        e.lt_idx = op[2]
                        break
            elif op[0] == 4:           # max_long_term_frame_idx
                self._dpb = [e for e in self._dpb
                             if not (e.long_term and
                                     e.lt_idx > op[1] - 1)]
            elif op[0] == 5:           # unmark all
                self._dpb = []
                self._poc_state = (0, 0)
            elif op[0] == 6:           # mark CURRENT pic long-term
                self._mark_lt = op[1]

    @staticmethod
    def _parse_weight_table(gb, nref0, nref1):
        """pred_weight_table (7.3.3.2). Returns (luma_denom,
        chroma_denom, wtab) with wtab[lst] an (nref, 3, 2) int array of
        [y,u,v][weight, offset]."""
        dy = gb.get_ue_golomb()
        dc = gb.get_ue_golomb()
        if dy > 7 or dc > 7:
            raise AVError(INVALIDDATA, "bad weight denom")
        tabs = []
        for nref in (nref0, nref1):
            t = np.zeros((max(nref, 1), 3, 2), dtype=np.int32)
            t[:, 0, 0] = 1 << dy
            t[:, 1, 0] = t[:, 2, 0] = 1 << dc
            for r in range(nref):
                if gb.get_bits(1):               # luma_weight_flag
                    t[r, 0, 0] = gb.get_se_golomb()
                    t[r, 0, 1] = gb.get_se_golomb()
                if gb.get_bits(1):               # chroma_weight_flag
                    for c in (1, 2):
                        t[r, c, 0] = gb.get_se_golomb()
                        t[r, c, 1] = gb.get_se_golomb()
            tabs.append(t)
        return (dy, dc, tabs)

    @staticmethod
    def _implicit_w0(cur_poc, list0, list1):
        """Implicit bipred weight table (8.4.2.3.2; reference
        h264_slice.c implicit_weight_table): w0[r0, r1] with
        w1 = 64 - w0, logWD = 5."""
        n0, n1 = max(len(list0), 1), max(len(list1), 1)
        w0 = np.full((n0, n1), 32, dtype=np.int32)
        clip8 = lambda v: max(-128, min(127, v))
        for i0, e0 in enumerate(list0):
            for i1, e1 in enumerate(list1):
                td = clip8(e1.poc - e0.poc)
                if td == 0:
                    continue
                tb = clip8(cur_poc - e0.poc)
                num = 16384 + (abs(td) >> 1)
                tx = num // td if td > 0 else -(num // -td)
                dsf = (tb * tx + 32) >> 8
                if -64 <= dsf <= 128:
                    w0[i0, i1] = 64 - dsf
        return w0

    def _col_motion(self, fd):
        """Packed (refIdxCol, mvCol, refPocCol) grid saved with
        reference frames for direct prediction (spec 8.4.1.2.2
        colZeroFlag; 8.4.1.2.3 needs the POC of the picture each
        colocated block referenced for DistScaleFactor).  Returns one
        contiguous (bh, bw, 4) int32 array of (ref, mvx, mvy, refpoc)
        — a single native pass over the cabac engine's arena grids."""
        l0pocs = np.ascontiguousarray(
            [e.poc for e in (fd.list0 or [])] + [0], np.int32)
        l1pocs = np.ascontiguousarray(
            [e.poc for e in (fd.list1 or [])] + [0], np.int32)

        def pocs_of(pocs, ref):
            return np.where(
                ref >= 0,
                pocs[np.clip(ref, 0, len(pocs) - 1)], 0).astype(np.int32)

        if fd.engine == "cavlc":
            colref, colmv = _mb_blocks(fd)
            packed = np.empty(colref.shape + (4,), np.int32)
            packed[..., 0] = colref
            packed[..., 1:3] = colmv
            packed[..., 3] = pocs_of(l0pocs, colref)
            return packed
        g = fd.grids
        if fd.engine == "cabac":
            from libav_tpu_torch.native import h264_cabac_host as CN
            return CN.col_pack(g.bref, g.bmv, l0pocs, l1pocs)
        b0, b1 = g.bref[0], g.bref[1]
        use0 = b0 >= 0
        packed = np.empty(b0.shape + (4,), np.int32)
        packed[..., 0] = np.where(use0, b0, np.where(b1 >= 0, b1, -1))
        packed[..., 1:3] = np.where(use0[..., None], g.bmv[0], g.bmv[1])
        packed[..., 3] = np.where(use0, pocs_of(l0pocs, b0),
                                  pocs_of(l1pocs, b1))
        return packed

    def _reconstruct(self, fd: FrameData, slice_info) -> Frame:
        sps, deblock, ab_offset, weights, pps = fd.recon_ctx
        # scaling matrices + chroma qp offsets in effect (hashable: part
        # of recon_h264_sparse's cache key; None = flat matrices)
        wmat = None
        cqpo = (0, 0)
        if pps is not None:
            o1 = pps.chroma_qp_index_offset
            o2 = pps.second_chroma_qp_index_offset
            cqpo = (o1, o1 if o2 is None else o2)
            if pps.scaling_m4 is not None or sps.scaling_m4 is not None \
                    or pps.scaling_m8 is not None \
                    or sps.scaling_m8 is not None:
                m4, m8 = sets.effective_matrices(sps, pps)
                wmat = (tuple(tuple(int(x) for x in m) for m in m4),
                        tuple(tuple(int(x) for x in m) for m in m8))
        nmb = sps.mb_width * sps.mb_height
        slice_type, idr, poc, ref_idc = slice_info
        any_intra = bool(np.any(fd.intra))
        multi = bool(np.any(fd.ref_idx > 0))
        zero = lambda: _device.zero_refs_h264(sps.mb_width, sps.mb_height,
                                              device=self.device)
        bpred = slice_type == SLICE_B
        g = fd.grids
        part_mode = bool(g is not None and g.any_part)
        if weights == "implicit" and not bpred:
            weights = None
        if weights is not None:
            # weighted prediction is applied per block: force the
            # block-granular path
            part_mode = True
        if deblock and bpred:
            # B deblock always runs block-granular: bS needs both lists'
            # refs/MVs (spec 8.7.2.1)
            part_mode = True
        if deblock and multi and not part_mode:
            # the block-granular path carries real per-block reference
            # ids, which the multi-ref bS rule needs (spec 8.7.2.1)
            part_mode = True
        if part_mode and fd.engine == "cavlc":
            # the cavlc engine keeps per-MB motion only: spread it over
            # the block grids
            g.bref[0], g.bmv[0] = _mb_blocks(fd)
            g.bref[1] = part.NOREF
            g.bmv[1] = 0
        nrefs1 = 1
        refs1 = None
        # PAFF cross-parity chroma MV offset (spec 8.4.1.4.1): per-MB
        # +-2 quarter-pel from the parity difference current vs ref
        field_pic = bool(getattr(fd, "field_info", (0, 0, False))[0])
        cur_par = getattr(fd, "field_info", (0, 0, False))[1]
        any_cdy = False
        cdy_arr = None
        if field_pic and fd.list0:
            partab = np.array(
                [e.field_src[1] if e.field_src is not None else cur_par
                 for e in fd.list0], np.int32)
            cdy_tab = 2 * (cur_par - partab)
            if np.any(cdy_tab):
                if part_mode or bpred:
                    log.warning(self, "cross-parity field refs on the "
                                "block-granular path: chroma MV offset "
                                "not applied")
                else:
                    any_cdy = True
                    ri = np.clip(fd.ref_idx, 0, len(cdy_tab) - 1)
                    cdy_arr = cdy_tab[ri].astype(np.int32)

        def planes_of(e):
            # field views resolve to the frame entry's per-parity planes
            # (filled by the first field's recon, which always precedes)
            if e.planes is None and e.field_src is not None:
                src, par = e.field_src
                e.planes = (src.field_planes or {}).get(par)
            # gap dummies (8.2.5.2) share the pixels of the reference
            # they were concealed from, which may have been filled in
            # after the dummy was created (worker/main pipeline)
            while e.planes is None and e.src is not None:
                e = e.src
            return e.planes

        def stack(entries, n):
            # tuples of planes, which the recon program takes as they are
            dpb = [planes_of(e) for e in entries[:n]]
            while len(dpb) < n:
                dpb.append(zero())
            dpb = [d if d is not None else zero() for d in dpb]
            if n == 1:
                return dpb[0]
            return tuple(tuple(d[k] for d in dpb) for k in range(3))

        list0 = fd.list0 if fd.list0 is not None else list(self._dpb)
        list1 = fd.list1 if fd.list1 is not None else []
        if part_mode:
            nrefs = max(1, int(g.bref[0].max()) + 1)
            refs = stack(list0, nrefs)
            if bpred:
                nrefs1 = max(1, int(g.bref[1].max()) + 1)
                refs1 = stack(list1, nrefs1)
        elif bpred:
            # 16x16-only B frame: single reference per list
            # (spec 8.2.4.2.3 default lists, index 0)
            nrefs = 1
            refs = stack(list0, 1) if list0 else zero()
            refs1 = stack(list1, 1) if list1 else zero()
        elif multi:
            nrefs = int(fd.ref_idx.max()) + 1
            refs = stack(list0, nrefs)
        else:
            nrefs = 1
            refs = stack(list0, 1) if list0 else zero()
        # int16 halves the host->HBM coefficient upload (CAVLC levels fit
        # comfortably; the device side upcasts to int32 anyway); the AC
        # coefficients additionally go up sparse — only coded 4x4 blocks
        # travel, scattered to dense on device (transport-bound path)
        if fd.engine == "python":
            lac = np.ascontiguousarray(fd.luma_ac).reshape(nmb * 16, 16)
            cac = np.ascontiguousarray(fd.chroma_ac).reshape(nmb * 8, 16)
            yidx = np.flatnonzero(lac.any(axis=1)).astype(np.int32)
            cidx = np.flatnonzero(cac.any(axis=1)).astype(np.int32)
            ysrc = lac[yidx].astype(np.int16)
            csrc = cac[cidx].astype(np.int16)
        else:
            # the native engines emit the coded-block lists directly: no
            # host-side scan of dense coefficients
            yv_full, cv_full, sctx = fd.sparse
            ny, ncc = int(sctx[0]), int(sctx[1])
            yidx = sctx[2:2 + ny]
            cidx = sctx[2 + 16 * nmb:2 + 16 * nmb + ncc]
            ysrc, csrc = yv_full[:ny], cv_full[:ncc]
        ycap, ccap = _device.sparse_caps(sps.mb_width, sps.mb_height,
                                 len(yidx), len(cidx))
        # fresh buffers per picture: state_from_numpy copies them before
        # it returns, so reusing them would be safe only while the upload
        # stays synchronous. np.empty is safe: rows past the fill all
        # scatter to the dropped sentinel row on the device.
        yvals = np.empty((ycap, 16), np.int16)
        yvals[:len(yidx)] = ysrc
        cvals = np.empty((ccap, 16), np.int16)
        cvals[:len(cidx)] = csrc
        ypad = np.full(ycap, nmb * 16, np.int32)
        ypad[:len(yidx)] = yidx
        cpad = np.full(ccap, nmb * 8, np.int32)
        cpad[:len(cidx)] = cidx
        cl, cr, ct, cb = sps.crop
        any_i4 = bool(np.any(fd.i4))
        t8arr = getattr(fd, "transform8", None)
        any_t8 = bool(t8arr is not None and np.any(t8arr))
        any_i8 = bool(any_t8 and np.any(np.asarray(fd.i4, bool)
                                        & np.asarray(t8arr, bool)))
        ipcm = getattr(fd, "ipcm", None)
        any_ipcm = bool(ipcm is not None and np.any(ipcm))
        # all-zero DC planes travel as a static flag, not 400KB of zeros
        any_ydc = bool(np.any(fd.luma_dc))
        any_cdc = bool(np.any(fd.chroma_dc))
        recon_h264_sparse_jit = hwdevice.program_factory(
            _device.recon_h264_sparse, self.device)
        fn = recon_h264_sparse_jit(sps.mb_width, sps.mb_height, any_intra,
                                   ycap, ccap,
                                   crop=(cl, cr, ct, cb,
                                         sps.width, sps.height),
                                   deblock=deblock, nrefs=nrefs,
                                   db_offsets=tuple(ab_offset),
                                   any_i4=any_i4, bpred=bpred,
                                   part=part_mode, nrefs1=nrefs1,
                                   weighted=(
                                       "i" if weights == "implicit" else
                                       ("e", weights[0], weights[1])
                                       if weights is not None else None),
                                   wmat=wmat, cqpo=cqpo, any_t8=any_t8,
                                   any_i8=any_i8, any_ipcm=any_ipcm,
                                   field=field_pic, any_cdy=any_cdy,
                                   any_ydc=any_ydc, any_cdc=any_cdc)
        kw = {}
        if any_ipcm:
            kw["ipcm"] = ipcm.astype(bool)
            kw["ipcm_y"] = fd.ipcm_y
            kw["ipcm_u"] = fd.ipcm_u
            kw["ipcm_v"] = fd.ipcm_v
        if any_t8:
            kw["t8"] = np.asarray(t8arr).astype(bool)
        if deblock:
            # the loop filter's bS derivation needs the coded-block grid
            # (part_mode defers to the C export pass below when it can)
            if not part_mode:
                kw["nnz"] = np.clip(fd.nnz_y, 0, 127).astype(np.int8)
        if nrefs > 1 and not part_mode:
            kw["ref_idx"] = fd.ref_idx.astype(np.int8)
        if any_i4:
            kw["i4"] = fd.i4.astype(bool)
            kw["i4_modes"] = fd.i4_modes.astype(np.int8)
        if bpred and not part_mode:
            kw["mv1"] = fd.mv1.astype(np.int16)
            kw["sel"] = fd.sel.astype(np.int8)
            kw["ry1"], kw["ru1"], kw["rv1"] = refs1
        if part_mode:
            if fd.engine == "cabac":
                # the arena grids: one C pass packs the whole transport
                # (final dtypes, incl. deblock pids + nnz clip)
                from libav_tpu_torch.native import h264_cabac_host as CN
                kw.update(CN.export_blocks(
                    g.bref, g.bmv, fd.nnz_y if deblock else None, nrefs,
                    nrefs1, fd.l0pid if deblock else None,
                    fd.l1pid if deblock else None, want_b=bpred,
                    want_pid=deblock, want_nnz=deblock,
                    zero_bmv1=deblock and not bpred))
                if bpred:
                    kw["ry1"], kw["ru1"], kw["rv1"] = refs1
            else:
                use0 = g.bref[0] >= 0
                use1 = g.bref[1] >= 0
                kw["bmv0"] = g.bmv[0].astype(np.int16)
                kw["bref0"] = np.clip(g.bref[0], 0,
                                      nrefs - 1).astype(np.int8)
                kw["bsel"] = np.where(use0 & use1, 2,
                                      np.where(use1, 1, 0)).astype(np.int8)
                if bpred:
                    kw["bmv1"] = g.bmv[1].astype(np.int16)
                    kw["bref1"] = np.clip(g.bref[1], 0,
                                          nrefs1 - 1).astype(np.int8)
                    kw["ry1"], kw["ru1"], kw["rv1"] = refs1
                if deblock:
                    # per-block picture ids for the bS reference
                    # comparison (against the DPB as this frame saw it)
                    l0p = fd.l0pid
                    l1p = fd.l1pid
                    kw["pid0"] = np.where(
                        use0, l0p[np.clip(g.bref[0], 0, len(l0p) - 1)],
                        -1).astype(np.int8)
                    kw["pid1"] = np.where(
                        use1, l1p[np.clip(g.bref[1], 0, len(l1p) - 1)],
                        -1).astype(np.int8)
                    if not bpred:
                        kw["bmv1"] = np.zeros_like(g.bmv[1],
                                                   dtype=np.int16)
            if deblock and "nnz" not in kw:
                kw["nnz"] = np.clip(fd.nnz_y, 0, 127).astype(np.int8)
            if weights == "implicit":
                w0 = self._implicit_w0(
                    poc if poc is not None else 0, list0[:nrefs],
                    list1[:nrefs1])
                full = np.full((nrefs, nrefs1), 32, np.int32)
                full[:w0.shape[0], :w0.shape[1]] = w0
                kw["w0tab"] = full
            elif weights is not None:
                kw["wtab0"] = weights[2][0][:nrefs].astype(np.int32)
                if bpred:
                    kw["wtab1"] = weights[2][1][:nrefs1].astype(np.int32)
        starts = [s for s in getattr(fd, "slice_starts", []) if s > 0]
        if starts and any_intra:
            # intra prediction must not cross slice boundaries
            # (row-aligned slices: kill the top availability of each
            # slice's first MB row)
            rt = np.ones(sps.mb_height, dtype=bool)
            rt[0] = False
            for s in starts:
                rt[min(s // sps.mb_width, sps.mb_height - 1)] = False
            kw["row_top"] = rt
        if any_cdy:
            kw["cdy"] = cdy_arr
        planes, padded = fn(fd.intra.astype(bool),
                            fd.luma_mode.astype(np.int8),
                            fd.chroma_mode.astype(np.int8),
                            fd.mv.astype(np.int16),
                            fd.qp.astype(np.int8),
                            fd.luma_dc.astype(np.int16) if any_ydc
                            else None,
                            yvals, ypad, cvals, cpad,
                            fd.chroma_dc.astype(np.int16) if any_cdc
                            else None, *refs, **kw)
        if getattr(fd, "dpb_entry", None) is not None:
            if getattr(fd, "dpb_parity", None) is not None:
                fd.dpb_entry.field_planes[fd.dpb_parity] = padded
            else:
                fd.dpb_entry.planes = padded
        f = Frame(width=sps.width, height=sps.height, format="yuv420p")
        f.planes = list(planes)     # cropped inside the device program
        f.pict_type = (PictureType.I if slice_type == SLICE_I else
                       PictureType.B if slice_type == SLICE_B else
                       PictureType.P)
        f.key_frame = bool(idr)
        f.poc = poc if poc is not None else 0
        return f


def native_cabac_available() -> bool:
    """Whether the host entropy layer runs the native C CABAC decoder
    (otherwise the slower pure-Python path decodes, with the same
    output)."""
    from libav_tpu_torch.native import h264_cabac_host
    return h264_cabac_host.available()


def host_entropy_stats():
    """(access units, seconds) spent in host entropy decoding in this
    process: the decoder's "h264.entropy" timer span, which wraps each
    access unit's header parsing, slice entropy and DPB update."""
    n, total, _, _ = timer.stats().get("h264.entropy", (0, 0.0, 0.0, 0.0))
    return n, total
