"""H.263 (ITU-T H.263-1996 baseline) and Sorenson H.263 (FLV1) decoders
(counterpart of `libav_tpu/codecs/h263dec.py`; reference:
libavcodec/ituh263dec.c — ff_h263_decode_picture_header,
ff_h263_decode_mb, h263_decode_motion; flvdec.c; shared mpegvideo recon).

Host, the JAX package's code, copied and changed only in its imports and
where it reaches a device program: picture headers (PTYPE, PLUSPTYPE with
custom sizes, FLV's), the MB layer (COD, MCBPC/CBPY from the MPEG-4
short-header set, DQUANT, median MV prediction, TCOEF with the H.263 and
Sorenson escapes, INTRADC) and the concealment of a damaged picture
(codecs/er.py). Device, on the decoder's torch device (`H263Decoder(params,
device="cuda")` by default; "cpu" runs the same program on the CPU): one
`codecs/mpegvideo.py` `Recon` per picture of the 'h263sh' kind (fixed DC
scaler 8, (2|L|+1)q dequant, H.263 chroma vector rounding), whose IDCT is
one launch of kernel K2. Baseline only: I/P pictures, formats
sub-QCIF..16CIF; PB-frames, OBMC, long vectors, SAC, AIC and the other
H.263+ coding modes are rejected as unsupported."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice, log
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet, PictureType
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.mpeg4 import tables as T
from libav_tpu_torch.codecs.mpeg4.dec import _VopPred
from libav_tpu_torch.codecs.mpeg12.dec import MBData
from libav_tpu_torch.codecs import mpegvideo

# ff_h263_format (h263data.c): source format -> (width, height)
H263_FORMATS = {1: (128, 96), 2: (176, 144), 3: (352, 288),
                4: (704, 576), 5: (1408, 1152)}


def _sign_extend(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return ((v + m) & (2 * m - 1)) - m


@register_codec
class H263Decoder(Decoder):
    NAME = "h263"
    TYPE = MediaType.VIDEO
    LONG_NAME = "H.263 / H.263-1996 baseline"

    FLV_ESC = 0        # 0 = H.263 escapes; 2 = Sorenson 7/11-bit

    def __init__(self, params=None, options=None, *, device="cuda"):
        """H263Decoder(params, options, device=...) — planes of the
        output frames (and the references) are uint8 tensors on
        `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self.width = self.height = 0
        self.mb_w = self.mb_h = 0
        self._refs = None

    def _flush(self):
        self._refs = None

    def _parse_picture_header(self, gb):
        """-> (pict_type, qscale); sets width/height/mb dims."""
        # picture start code: 22 bits 0000 0000 0000 0000 1 00000
        if gb.get_bits(22) != 0x20:
            raise AVError(INVALIDDATA, "h263: bad picture start code")
        gb.get_bits(8)                        # temporal reference
        if gb.get_bits(1) != 1 or gb.get_bits(1) != 0:
            raise AVError(INVALIDDATA, "h263: bad PTYPE marker/id")
        gb.skip_bits(3)                       # split/camera/freeze
        fmt = gb.get_bits(3)
        if fmt == 7:
            return self._parse_plusptype(gb)
        if fmt not in H263_FORMATS:
            raise AVError(INVALIDDATA, f"h263: bad source format {fmt}")
        self.width, self.height = H263_FORMATS[fmt]
        self.mb_w = (self.width + 15) >> 4
        self.mb_h = (self.height + 15) >> 4
        pict_type = gb.get_bits(1)            # 0=I 1=P
        if gb.get_bits(1):
            raise AVError(INVALIDDATA, "h263: long vectors unsupported")
        if gb.get_bits(1):
            raise AVError(INVALIDDATA, "h263: SAC unsupported")
        if gb.get_bits(1):
            raise AVError(INVALIDDATA, "h263: OBMC unsupported")
        if gb.get_bits(1):
            raise AVError(INVALIDDATA, "h263: PB frames unsupported")
        qscale = gb.get_bits(5)
        gb.skip_bits(1)                       # CPM (off)
        while gb.get_bits(1):                 # PEI extension bytes
            gb.skip_bits(8)
        return pict_type, qscale

    def _parse_plusptype(self, gb):
        """H.263+ PLUSPTYPE (ituh263dec.c h263_plus branch): UFEP +
        OPPTYPE (persisted across pictures when UFEP=0) + MPPTYPE +
        CPFMT custom dimensions; optional coding modes are rejected
        (the reference encoder emits none without explicit flags)."""
        ufep = gb.get_bits(3)
        if ufep == 1:
            fmt = gb.get_bits(3)
            custom_pcf = gb.get_bits(1)
            umvplus = gb.get_bits(1)
            sac = gb.get_bits(1)
            obmc = gb.get_bits(1)
            aic = gb.get_bits(1)
            loopf = gb.get_bits(1)
            sliced = gb.get_bits(1)
            rps = gb.get_bits(1)
            isd = gb.get_bits(1)
            aiv = gb.get_bits(1)
            modq = gb.get_bits(1)
            if umvplus or sac or obmc or aic or loopf \
                    or sliced or rps or isd or aiv or modq:
                raise AVError(INVALIDDATA, "h263+: optional coding "
                              "modes not supported")
            gb.skip_bits(1 + 3)               # marker + reserved
            self._plus_fmt = fmt
            self._custom_pcf = custom_pcf
        elif ufep != 0:
            raise AVError(INVALIDDATA, "h263+: bad UFEP")
        fmt = getattr(self, "_plus_fmt", None)
        if fmt is None:
            raise AVError(INVALIDDATA, "h263+: missing OPPTYPE")
        ptype = gb.get_bits(3)                # MPPTYPE
        if ptype == 0:
            pict_type = 0
        elif ptype == 1:
            pict_type = 1
        else:
            raise AVError(INVALIDDATA, "h263+: PB/B pictures "
                                       "unsupported")
        gb.skip_bits(2)                       # RPR / RRU
        no_rounding = gb.get_bits(1)          # RTYPE
        gb.skip_bits(4)                       # reserved(2)+CPM+PSBI? (3
                                              # reserved + CPM handled
                                              # below by the reference)
        if ufep:
            if fmt == 6:                      # CPFMT
                ar = gb.get_bits(4)           # aspect ratio
                w = (gb.get_bits(9) + 1) * 4
                gb.skip_bits(1)
                h = gb.get_bits(9) * 4
                if ar == 15:                  # extended PAR
                    gb.get_bits(8)
                    gb.get_bits(8)
                self.width, self.height = w, h
            else:
                if fmt not in H263_FORMATS:
                    raise AVError(INVALIDDATA, "h263+: bad format")
                self.width, self.height = H263_FORMATS[fmt]
            if getattr(self, "_custom_pcf", 0):
                gb.get_bits(1)                # clock conversion code
                gb.get_bits(7)                # clock divisor
        if getattr(self, "_custom_pcf", 0):
            gb.skip_bits(2)                   # extended temporal ref
        self.mb_w = (self.width + 15) >> 4
        self.mb_h = (self.height + 15) >> 4
        qscale = gb.get_bits(5)
        while gb.get_bits(1):                 # PEI
            gb.skip_bits(8)
        self._no_rounding = no_rounding
        return pict_type, qscale

    def _decode(self, pkt: Packet) -> List[Frame]:
        gb = GetBits(bytes(pkt.data))
        pict_type, qscale = self._parse_picture_header(gb)

        nmb = self.mb_w * self.mb_h
        mb = MBData(nmb)
        mb.qscale[:] = max(qscale, 1)
        mb.skipped = np.zeros(nmb, dtype=bool)
        rounding = getattr(self, "_no_rounding", 0) if pict_type else 0
        pred = _VopPred(self.mb_w, self.mb_h)
        try:
            self._decode_mbs(gb, mb, pict_type, qscale, pred)
        except AVError as e:
            mb.ok[:] = False
            log.warning(self, "h263 MB decode error, concealing: %s", e)
        if not mb.ok.all():
            from libav_tpu_torch.codecs.er import conceal_missing
            conceal_missing(mb, self.mb_w, self.mb_h,
                            self._refs is not None)

        dummy_q = torch.ones(64, dtype=torch.int32, device=self.device)
        recon_jit = hwdevice.program_factory(mpegvideo.recon, self.device)
        fn = recon_jit(self.mb_w, self.mb_h, "h263sh", False,
                       bool(pict_type), rounding)
        zero = mpegvideo.zero_pad_refs(self.mb_w, self.mb_h,
                                       device=self.device)
        r0 = self._refs or zero
        planes, padded = fn(mb.coeffs, mb.qscale, mb.intra, mb.use_fwd,
                            mb.use_bwd, mb.mv_fwd, mb.mv_bwd,
                            dummy_q, dummy_q, *r0, *zero)
        self._refs = padded
        f = Frame(width=self.width, height=self.height, format="yuv420p")
        f.planes = [planes[0][:self.height, :self.width],
                    planes[1][:self.height // 2, :self.width // 2],
                    planes[2][:self.height // 2, :self.width // 2]]
        f.pict_type = PictureType.P if pict_type else PictureType.I
        f.key_frame = not pict_type
        f.pts = pkt.pts
        f.time_base = pkt.time_base
        return [f]

    def _decode_mbs(self, gb, mb: MBData, pict_type, qscale, pred):
        mw, mh = self.mb_w, self.mb_h
        for mb_y in range(mh):
            for mb_x in range(mw):
                idx = mb_y * mw + mb_x
                four = False
                if pict_type:                 # P picture
                    if gb.get_bits(1):        # COD: skipped
                        mb.use_fwd[idx] = True
                        mb.mv_fwd[idx] = 0
                        mb.skipped[idx] = True
                        mb.ok[idx] = True
                        pred.grid_put(mb_x, mb_y, 0, 0, 0)
                        for k in range(1, 4):
                            pred.grid_put(mb_x, mb_y, k, 0, 0)
                        continue
                    v = T.inter_mcbpc_vlc().read(gb)
                    group, cbpc = v >> 2, v & 3
                    if group == 5:            # stuffing
                        continue
                    if group in (T.MBT_INTER4V, 6):
                        raise AVError(INVALIDDATA,
                                      "h263: 4MV (AP) unsupported")
                    is_intra = group in (T.MBT_INTRA, T.MBT_INTRAQ)
                    has_q = group in (T.MBT_INTERQ, T.MBT_INTRAQ)
                else:
                    v = T.intra_mcbpc_vlc().read(gb)
                    if v == 8:
                        continue              # stuffing
                    is_intra = True
                    has_q = v >= 4
                    cbpc = v & 3

                cbpy_code = T.cbpy_vlc().read(gb)
                cbpy = cbpy_code if is_intra else 15 - cbpy_code
                if has_q:
                    dq = gb.get_bits(2)
                    qscale = max(1, min(31,
                                        qscale + (-1, -2, 1, 2)[dq]))
                mb.qscale[idx] = qscale

                if is_intra:
                    mb.intra[idx] = True
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, 0, 0)
                else:
                    px, py = pred.grid_pred(mb_x, mb_y, 0)
                    vx = self._decode_motion(gb, px)
                    vy = self._decode_motion(gb, py)
                    mb.use_fwd[idx] = True
                    mb.mv_fwd[idx] = (vx, vy)
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, vx, vy)

                cbp = (cbpy << 2) | cbpc
                for b in range(6):
                    coded = bool(cbp & (0x20 >> b))
                    if is_intra:
                        # INTRADC: 8-bit FLC, 255 codes 128
                        # (ituh263dec.c h263_decode_block)
                        lvl = gb.get_bits(8)
                        if lvl == 255:
                            lvl = 128
                        mb.coeffs[idx, b, 0] = lvl
                        if coded:
                            self._rl_block(gb, mb.coeffs[idx, b], 1)
                    elif coded:
                        self._rl_block(gb, mb.coeffs[idx, b], 0)
                mb.ok[idx] = True

    @staticmethod
    def _decode_motion(gb, pred_v: int) -> int:
        """ituh263dec.c h263_decode_motion (no long vectors): pred +
        code, sign-extended to 6 bits (range -32..31 half-pel)."""
        code = T.mv_vlc().read(gb)
        if code == 0:
            val = 0
        else:
            val = -code if gb.get_bits(1) else code
        val += pred_v
        return _sign_extend(val, 6)

    def _rl_block(self, gb, out, start):
        """TCOEF 3D VLC (table 16 == the MPEG-4 inter RL table) with
        the H.263 22-bit escape: last(1) run(6) level(8 FLC signed,
        ituh263dec.c h263_decode_block ESCAPE branch)."""
        vlc = T.rl_vlc(False)
        tuples = T.rl_decode_tuple(False)
        k = start
        while True:
            v = vlc.read(gb)
            if v == T.ESC_INDEX:
                if self.FLV_ESC == 2:
                    # Sorenson escape (flvdec.c ff_flv2_decode_ac_esc)
                    is11 = gb.get_bits(1)
                    last = gb.get_bits(1)
                    run = gb.get_bits(6)
                    level = gb.get_sbits(11 if is11 else 7)
                    if level == 0:
                        raise AVError(INVALIDDATA,
                                      "flv: illegal escape level")
                    k += run
                    if k > 63:
                        raise AVError(INVALIDDATA,
                                      "flv: AC index overflow")
                    out[k] = level
                    k += 1
                    if last:
                        break
                    continue
                last = gb.get_bits(1)
                run = gb.get_bits(6)
                level = gb.get_sbits(8)
                if level == -128:
                    # extended 11-bit level (ituh263dec.c:524)
                    level = gb.get_bits(5)
                    level |= gb.get_sbits(6) << 5
                if level == 0:
                    raise AVError(INVALIDDATA, "h263: illegal escape "
                                               "level")
            else:
                last, run, level = tuples[v]
                if gb.get_bits(1):
                    level = -level
            k += run
            if k > 63:
                raise AVError(INVALIDDATA, "h263: AC index overflow")
            out[k] = level
            k += 1
            if last:
                break


@register_codec
class FLV1Decoder(H263Decoder):
    """Sorenson H.263 / FLV1 (reference: libavcodec/flvdec.c
    ff_flv_decode_picture_header + the flv2 AC escape in
    ituh263dec.c:514): H.263 MB layer with an FLV picture header,
    arbitrary frame sizes and the 7/11-bit escape when format=1."""
    NAME = "flv1"
    LONG_NAME = "FLV / Sorenson Spark"

    def _parse_picture_header(self, gb):
        if gb.get_bits(17) != 1:
            raise AVError(INVALIDDATA, "flv: bad picture start code")
        esc_fmt = gb.get_bits(5)
        if esc_fmt > 1:
            raise AVError(INVALIDDATA, "flv: bad picture format")
        self.FLV_ESC = esc_fmt + 1            # 1 = h263 esc, 2 = flv2
        gb.get_bits(8)                        # picture timestamp
        sz = gb.get_bits(3)
        if sz == 0:
            w, h = gb.get_bits(8), gb.get_bits(8)
        elif sz == 1:
            w, h = gb.get_bits(16), gb.get_bits(16)
        else:
            w, h = {2: (352, 288), 3: (176, 144), 4: (128, 96),
                    5: (320, 240), 6: (160, 120)}.get(sz, (0, 0))
        if not w or not h:
            raise AVError(INVALIDDATA, "flv: bad size")
        self.width, self.height = w, h
        self.mb_w = (w + 15) >> 4
        self.mb_h = (h + 15) >> 4
        pict_type = gb.get_bits(2)            # 0=I 1=P 2=disposable P
        gb.skip_bits(1)                       # deblocking flag
        qscale = gb.get_bits(5)
        while gb.get_bits(1):                 # PEI
            gb.skip_bits(8)
        return (1 if pict_type else 0), qscale
