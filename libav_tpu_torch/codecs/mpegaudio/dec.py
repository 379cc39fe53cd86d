"""MPEG audio decoder — Layers I/II/III, MPEG-1 + MPEG-2 LSF
(reference behavior: libavcodec/mpegaudiodec_template.c —
mp_decode_layer1 :481, mp_decode_layer2 :546, mp_decode_layer3 :1271,
huffman_decode :830, compute_stereo :1016, compute_antialias :1161,
compute_imdct :1191; float output parity vs the mp{1,2,3}float
decoders).

Host: serial bitstream work (header, allocation, scalefactors, Layer
III side info + Huffman).  The numeric tail (dequant is vectorized
numpy; the 32-band synthesis filterbank is a materialized 16-tap
matrix convolution, synth.py) processes a whole frame of slots at
once.

Counterpart of `libav_tpu/codecs/mpegaudio/dec.py`, copied: all of it
runs on the host in both packages. The decoder takes a device like every
decoder of the port and hands out numpy float planes.
"""

from __future__ import annotations

from typing import List

import numpy as np

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.avutil.samplefmt import default_channel_layout
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.bitstream.vlc import VLC
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.mpegaudio import tables as T
from libav_tpu_torch.codecs.mpegaudio.synth import SynthState

MODE_STEREO, MODE_JSTEREO, MODE_DUAL, MODE_MONO = range(4)


def parse_header(h: int):
    """Returns dict or None (reference: avpriv_mpegaudio_decode_header).
    h = 32-bit big-endian value at frame start."""
    if (h >> 21) & 0x7FF != 0x7FF:
        return None
    ver = (h >> 19) & 3              # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
    if ver == 1:
        return None
    layer = 4 - ((h >> 17) & 3)      # 1..3
    if layer == 4:
        return None
    protection = not ((h >> 16) & 1)
    bitrate_index = (h >> 12) & 0xF
    sr_index = (h >> 10) & 3
    if sr_index == 3 or bitrate_index == 15:
        return None
    padding = (h >> 9) & 1
    mode = (h >> 6) & 3
    mode_ext = (h >> 4) & 3
    lsf = ver != 3
    mpeg25 = ver == 0
    sample_rate = T.FREQ_TAB[sr_index] >> (lsf + mpeg25)
    if bitrate_index == 0:
        return None                  # free format unsupported
    br = T.BITRATE_TAB[lsf][layer - 1][bitrate_index] * 1000
    if layer == 1:
        frame_size = (br * 12 // sample_rate + padding) * 4
        samples = 384
    elif layer == 2:
        frame_size = br * 144 // sample_rate + padding
        samples = 1152
    else:
        coef = 72 if lsf else 144
        frame_size = br * coef // sample_rate + padding
        samples = 576 if lsf else 1152
    return dict(layer=layer, sample_rate=sample_rate, lsf=lsf,
                mpeg25=mpeg25, bit_rate=br, mode=mode, mode_ext=mode_ext,
                channels=1 if mode == MODE_MONO else 2,
                frame_size=frame_size, samples=samples,
                protection=protection, sr_index=sr_index)


def frame_info(data: bytes):
    """(frame_size, sample_rate, channels, samples) or None — used by
    the raw demuxer/parser probe."""
    if len(data) < 4:
        return None
    hdr = parse_header(int.from_bytes(data[:4], "big"))
    if hdr is None:
        return None
    return hdr["frame_size"], hdr["sample_rate"], hdr["channels"], \
        hdr["samples"]


# -- dequant (float, spec-normalized; see synth.py scale note) ----------

_SF = 2.0 ** (-np.arange(64) / 3.0)          # 2^(-sf/3)


def _l1_unscale(n, mant, sf):
    """(mant - 2^n + 1) * 2^(n+1)/(2^(n+1)-1) * 2^(1-sf/3) / 2^n
    (reference l1_unscale math in float)."""
    nb = n + 1
    norm = float(1 << nb) / ((1 << nb) - 1)
    return (mant - (1 << n) + 1) * norm * 2.0 * _SF[sf] / (1 << n)


_L2_GROUP_MULT = {3: 4.0 / 3.0, 5: 4.0 / 5.0, 9: 4.0 / 9.0}


def _l2_unscale_group(steps, mant, sf):
    """(mant - steps//2) * C_steps * 2^(-sf/3) — C from spec Table
    3-B.4 (4/3, 4/5, 4/9), matching l2_unscale_group/scale_factor_mult2
    in FRAC_ONE=1.0 normalization."""
    return (mant - (steps >> 1)) * _L2_GROUP_MULT[steps] * _SF[sf]


def _decode_layer1(gb: GetBits, hdr) -> np.ndarray:
    nch = hdr["channels"]
    bound = (hdr["mode_ext"] + 1) * 4 if hdr["mode"] == MODE_JSTEREO \
        else 32
    alloc = np.zeros((2, 32), dtype=np.int64)
    sf = np.zeros((2, 32), dtype=np.int64)
    for i in range(bound):
        for ch in range(nch):
            alloc[ch][i] = gb.get_bits(4)
    for i in range(bound, 32):
        alloc[0][i] = gb.get_bits(4)
    for i in range(bound):
        for ch in range(nch):
            if alloc[ch][i]:
                sf[ch][i] = gb.get_bits(6)
    for i in range(bound, 32):
        if alloc[0][i]:
            sf[0][i] = gb.get_bits(6)
            sf[1][i] = gb.get_bits(6)
    sb = np.zeros((2, 12, 32))
    for j in range(12):
        for i in range(bound):
            for ch in range(nch):
                n = int(alloc[ch][i])
                if n:
                    mant = gb.get_bits(n + 1)
                    sb[ch][j][i] = _l1_unscale(n, mant, sf[ch][i])
        for i in range(bound, 32):
            n = int(alloc[0][i])
            if n:
                mant = gb.get_bits(n + 1)
                sb[0][j][i] = _l1_unscale(n, mant, sf[0][i])
                sb[1][j][i] = _l1_unscale(n, mant, sf[1][i])
    return sb[:nch]


def _l2_select_table(bitrate_kbps, nch, freq, lsf):
    """reference: mpegaudio.c ff_mpa_l2_select_table."""
    ch_bitrate = bitrate_kbps // nch
    if lsf:
        return 4
    if (freq == 48000 and ch_bitrate >= 56) or (56 <= ch_bitrate <= 80):
        return 0
    if freq != 48000 and ch_bitrate >= 96:
        return 1
    if freq != 32000 and ch_bitrate <= 48:
        return 2
    return 3


def _decode_layer2(gb: GetBits, hdr) -> np.ndarray:
    nch = hdr["channels"]
    table = _l2_select_table(hdr["bit_rate"] // 1000, nch,
                             hdr["sample_rate"], hdr["lsf"])
    sblimit = T.SBLIMIT_TABLE[table]
    at = T.ALLOC_TABLES[table]
    bound = (hdr["mode_ext"] + 1) * 4 if hdr["mode"] == MODE_JSTEREO \
        else sblimit
    bound = min(bound, sblimit)

    bit_alloc = np.zeros((2, 32), dtype=np.int64)
    j = 0
    for i in range(bound):
        nb = at[j]
        for ch in range(nch):
            bit_alloc[ch][i] = gb.get_bits(nb)
        j += 1 << nb
    for i in range(bound, sblimit):
        nb = at[j]
        v = gb.get_bits(nb)
        bit_alloc[0][i] = v
        bit_alloc[1][i] = v
        j += 1 << nb

    scale_code = np.zeros((2, 32), dtype=np.int64)
    for i in range(sblimit):
        for ch in range(nch):
            if bit_alloc[ch][i]:
                scale_code[ch][i] = gb.get_bits(2)
    sf = np.zeros((2, 32, 3), dtype=np.int64)
    for i in range(sblimit):
        for ch in range(nch):
            if bit_alloc[ch][i]:
                code = scale_code[ch][i]
                if code == 0:
                    sf[ch][i] = [gb.get_bits(6) for _ in range(3)]
                elif code == 2:
                    v = gb.get_bits(6)
                    sf[ch][i] = [v, v, v]
                elif code == 1:
                    a, c = gb.get_bits(6), gb.get_bits(6)
                    sf[ch][i] = [a, a, c]
                else:
                    a, c = gb.get_bits(6), gb.get_bits(6)
                    sf[ch][i] = [a, c, c]

    sb = np.zeros((2, 36, 32))
    for k in range(3):
        for l in range(0, 12, 3):
            j = 0
            for i in range(bound):
                nb = at[j]
                for ch in range(nch):
                    b = int(bit_alloc[ch][i])
                    if b:
                        scale = int(sf[ch][i][k])
                        qindex = at[j + b]
                        bits = T.QUANT_BITS[qindex]
                        if bits < 0:
                            steps = T.QUANT_STEPS[qindex]
                            v = gb.get_bits(-bits)
                            for m in range(3):
                                sb[ch][k * 12 + l + m][i] = \
                                    _l2_unscale_group(steps, v % steps,
                                                      scale)
                                v //= steps
                        else:
                            for m in range(3):
                                v = gb.get_bits(bits)
                                sb[ch][k * 12 + l + m][i] = \
                                    _l1_unscale(bits - 1, v, scale)
                j += 1 << nb
            for i in range(bound, sblimit):
                nb = at[j]
                b = int(bit_alloc[0][i])
                if b:
                    s0, s1 = int(sf[0][i][k]), int(sf[1][i][k])
                    qindex = at[j + b]
                    bits = T.QUANT_BITS[qindex]
                    if bits < 0:
                        steps = T.QUANT_STEPS[qindex]
                        v = gb.get_bits(-bits)
                        for m in range(3):
                            mant = v % steps
                            v //= steps
                            sb[0][k * 12 + l + m][i] = \
                                _l2_unscale_group(steps, mant, s0)
                            sb[1][k * 12 + l + m][i] = \
                                _l2_unscale_group(steps, mant, s1)
                    else:
                        for m in range(3):
                            mant = gb.get_bits(bits)
                            sb[0][k * 12 + l + m][i] = \
                                _l1_unscale(bits - 1, mant, s0)
                            sb[1][k * 12 + l + m][i] = \
                                _l1_unscale(bits - 1, mant, s1)
                j += 1 << nb
    return sb[:nch]


@register_codec
class MpegAudioDecoder(Decoder):
    NAME = "mp3"
    ALIASES = ("mp2", "mp1", "mp3float", "mp2float")
    TYPE = MediaType.AUDIO
    LONG_NAME = "MP1/MP2/MP3 (MPEG audio layers I-III)"

    def __init__(self, params=None, options=None, *, device="cuda"):
        """MpegAudioDecoder(params, options, device=...): the decode runs on the
        host; the device is taken like every decoder of the port's."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self._synth = None
        self._l3 = None

    def _flush(self):
        self._synth = None
        self._l3 = None

    def _decode(self, pkt: Packet) -> List[Frame]:
        data = pkt.data
        if len(data) < 4:
            return []
        hdr = parse_header(int.from_bytes(data[:4], "big"))
        if hdr is None:
            raise AVError(INVALIDDATA, "bad mpeg audio header")
        gb = GetBits(data[4:hdr["frame_size"]])
        if hdr["protection"]:
            gb.skip_bits(16)         # crc
        nch = hdr["channels"]
        if hdr["layer"] == 1:
            sb = _decode_layer1(gb, hdr)
        elif hdr["layer"] == 2:
            sb = _decode_layer2(gb, hdr)
        else:
            from libav_tpu_torch.codecs.mpegaudio.layer3 import Layer3Decoder
            if self._l3 is None:
                self._l3 = Layer3Decoder()
            sb = self._l3.decode(gb, hdr, data[:hdr["frame_size"]])
            if sb is None:           # bit reservoir not yet primed
                return []
        if self._synth is None or len(self._synth) != nch:
            self._synth = [SynthState() for _ in range(nch)]
        pcm = [self._synth[ch].run(sb[ch]) for ch in range(nch)]
        f = Frame(nb_samples=len(pcm[0]), sample_rate=hdr["sample_rate"],
                  format="fltp", channels=nch,
                  channel_layout=default_channel_layout(nch))
        f.planes = [p.astype(np.float32) for p in pcm]
        f.pts = pkt.pts
        f.time_base = pkt.time_base
        return [f]
