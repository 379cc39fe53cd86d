"""avplay-semantics player of the port (counterpart of
`libav_tpu/tools/avplay.py`; reference: avtools/avplay.c — demux thread +
audio/video decode threads + refresh loop, A/V sync clocks :50-94).

No display server or sound card exists in this environment, so the
outputs are: video as a terminal renderer (half-block cells over 24-bit
ANSI color) or null; audio through a pacing sink that models a hardware
buffer (blocking writes drain at the device rate — the same
buffer-fullness clock semantics avplay derives from SDL's callback), a
raw PCM file, or an external player command (-ao "aplay -f cd -").

Sync model (avplay.c compute_target_delay / audio_clock): the audio
clock (pts of the last queued sample minus the sink's buffered delay)
is the master when audio exists; video frames are delayed, duplicated
or dropped against it with the AV_SYNC_THRESHOLD rule.  Without audio,
video paces against the wall clock.

The decoders run on one torch device, "cuda" unless the caller names
another: `python -m libav_tpu_torch.tools.avplay [-vo null] input` on the
card, `main(argv, device="cpu")` or `play(url, device="cpu")` on the CPU.
The sinks, the clocks and the sync rule are the JAX package's.
"""

from __future__ import annotations

import queue
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.codecs import find_decoder
from libav_tpu_torch.codecs.api import MediaType
from libav_tpu_torch.formats import FormatContext

AV_SYNC_THRESHOLD = 0.01     # avplay.c:71
AV_NOSYNC_THRESHOLD = 10.0   # avplay.c:73


class AudioSink:
    """Blocking audio sink with hardware-buffer pacing semantics.

    write() blocks while the simulated device buffer is full; delay()
    reports the seconds of audio still buffered — exactly what the
    audio clock subtracts (avplay.c audio_decode_frame + sdl callback).
    """

    def __init__(self, rate: int, channels: int, mode: str = "sim",
                 path: Optional[str] = None, cmd: Optional[str] = None):
        self.rate = rate
        self.channels = channels
        self.mode = mode
        self.buffer_cap = 0.2          # seconds of simulated HW buffer
        self._end = time.perf_counter()
        self._file = open(path, "wb") if mode == "file" and path else None
        self._proc = None
        if mode == "cmd" and cmd:
            self._proc = subprocess.Popen(
                cmd.split(), stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def write(self, s16_interleaved: np.ndarray):
        n = len(s16_interleaved) // self.channels
        now = time.perf_counter()
        if self._end - now > self.buffer_cap:
            time.sleep(self._end - now - self.buffer_cap)
            now = time.perf_counter()
        self._end = max(now, self._end) + n / self.rate
        if self._file is not None:
            self._file.write(s16_interleaved.astype("<i2").tobytes())
        if self._proc is not None and self._proc.stdin:
            try:
                self._proc.stdin.write(
                    s16_interleaved.astype("<i2").tobytes())
            except BrokenPipeError:
                self._proc = None

    def delay(self) -> float:
        return max(0.0, self._end - time.perf_counter())

    def close(self):
        if self._file:
            self._file.close()
        if self._proc and self._proc.stdin:
            self._proc.stdin.close()
            self._proc.wait()


def _term_render(frame, device, cols=96):
    """Render a frame as ANSI half-blocks (2 pixels per cell); the scale
    and the RGB conversion run on device, the cells from host planes."""
    from libav_tpu_torch.swscale import SwsContext
    w = cols
    h = max(2, int(frame.height * w / max(frame.width, 1) / 2) * 2)
    sws = SwsContext.get(frame.width, frame.height, frame.format,
                         w, h, frame.format, device=device)
    small = sws.scale_frame(frame)
    rgbc = SwsContext.get(w, h, small.format, w, h, "rgb24", device=device)
    rgb = np.asarray(rgbc.scale_frame(small).to_host().planes[0]).reshape(
        h, w, 3)
    lines = []
    for y in range(0, h - 1, 2):
        row = []
        for x in range(w):
            t = rgb[y, x]
            b = rgb[y + 1, x]
            row.append(f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                       f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀")
        lines.append("".join(row) + "\x1b[0m")
    sys.stdout.write("\x1b[H" + "\n".join(lines) + "\n")
    sys.stdout.flush()


class Player:
    def __init__(self, url, vo="term", ao="sim", ao_path=None,
                 ao_cmd=None, max_frames=None, duration=None,
                 device="cuda"):
        self.device = hwdevice.device(device)
        self.ic = FormatContext.open_input(url)
        self.vo = vo
        self.max_frames = max_frames
        self.duration = duration
        self.vst = next((s for s in self.ic.streams
                         if s.codecpar.codec_type == MediaType.VIDEO),
                        None)
        self.ast = next((s for s in self.ic.streams
                         if s.codecpar.codec_type == MediaType.AUDIO),
                        None)
        self.vdec = (find_decoder(self.vst.codecpar.codec_id)
                     (self.vst.codecpar, device=self.device).open()
                     if self.vst else None)
        self.adec = (find_decoder(self.ast.codecpar.codec_id)
                     (self.ast.codecpar, device=self.device).open()
                     if self.ast else None)
        self.aq: "queue.Queue" = queue.Queue(maxsize=64)
        self.vq: "queue.Queue" = queue.Queue(maxsize=64)
        self.audio_clock = 0.0        # pts (s) at the END of sink queue
        self.audio_clock_time = time.perf_counter()
        self.sink = None
        self._resampler = None
        if self.ast:
            ch = min(2, max(1, self.ast.codecpar.channels or 2))
            self.sink = AudioSink(self.ast.codecpar.sample_rate or 48000,
                                  ch, mode=ao, path=ao_path, cmd=ao_cmd)
        self.eof = False

    # -- clocks (avplay.c get_audio_clock / get_video_clock) -----------

    def master_clock(self) -> Optional[float]:
        if self.sink is not None:
            return self.audio_clock - self.sink.delay()
        return None

    # -- threads ---------------------------------------------------------

    def _demux(self):
        try:
            for pkt in self.ic.packets():
                if self.vst and pkt.stream_index == self.vst.index:
                    self.vq.put(pkt)
                elif self.ast and pkt.stream_index == self.ast.index:
                    self.aq.put(pkt)
        except AVError:
            pass
        self.vq.put(None)
        self.aq.put(None)

    def _audio_thread(self):
        sink = self.sink
        ch = sink.channels
        while True:
            pkt = self.aq.get()
            if pkt is None:
                break
            try:
                self.adec.send_packet(pkt)
            except AVError:
                continue
            while True:
                try:
                    f = self.adec.receive_frame()
                except AVError:
                    break
                pcm = np.stack([np.asarray(p, dtype=np.float32)
                                for p in f.to_host().planes[:ch]])
                if pcm.shape[0] < ch:
                    pcm = np.repeat(pcm, ch, axis=0)[:ch]
                inter = np.clip(pcm.T.reshape(-1) * 32767.0,
                                -32768, 32767).astype(np.int16)
                if f.pts is not None and f.time_base:
                    pts = float(f.pts * f.time_base.num / f.time_base.den)
                else:
                    pts = self.audio_clock
                sink.write(inter)          # blocks: device pacing
                self.audio_clock = pts + f.nb_samples / (
                    f.sample_rate or sink.rate)
                if self.duration and self.audio_clock >= self.duration:
                    break

    # -- video refresh (avplay.c video_refresh/compute_target_delay) -----

    def _video_loop(self):
        fr = self.vst.avg_frame_rate if self.vst else None
        frame_dur = float(fr.inv()) if fr else 0.04
        t0 = time.perf_counter()
        shown = 0
        dropped = 0
        last_pts = 0.0
        while True:
            pkt = self.vq.get()
            if pkt is None:
                break
            try:
                self.vdec.send_packet(pkt)
            except AVError:
                continue
            while True:
                try:
                    frame = self.vdec.receive_frame()
                except AVError:
                    break
                if frame.pts is not None and frame.time_base:
                    vpts = float(frame.pts * frame.time_base.num /
                                 frame.time_base.den)
                else:
                    vpts = last_pts + frame_dur
                last_pts = vpts
                master = self.master_clock()
                if master is None:
                    # video-is-master: pace by wall clock
                    due = t0 + shown * frame_dur
                    delay = due - time.perf_counter()
                else:
                    diff = vpts - master
                    sync_thr = max(AV_SYNC_THRESHOLD, frame_dur)
                    delay = frame_dur
                    if abs(diff) < AV_NOSYNC_THRESHOLD:
                        if diff <= -sync_thr:
                            delay = 0.0          # behind: hurry/drop
                        elif diff >= sync_thr:
                            delay = 2 * frame_dur  # ahead: slow down
                    if delay == 0.0 and diff < -2 * sync_thr:
                        dropped += 1             # too late: drop frame
                        continue
                    delay = max(0.0, diff)
                if delay > 0:
                    time.sleep(min(delay, 0.5))
                if self.vo == "term":
                    _term_render(frame, self.device)
                shown += 1
                if self.max_frames and shown >= self.max_frames:
                    return shown, dropped
                if self.duration and vpts >= self.duration:
                    return shown, dropped
        return shown, dropped

    def run(self) -> int:
        threads = [threading.Thread(target=self._demux, daemon=True)]
        if self.sink is not None and self.adec is not None:
            threads.append(threading.Thread(target=self._audio_thread,
                                            daemon=True))
        for t in threads:
            t.start()
        if self.vo == "term":
            sys.stdout.write("\x1b[2J")
        if self.vdec is not None:
            shown, dropped = self._video_loop()
            sys.stderr.write(f"avplay: {shown} frames shown, "
                             f"{dropped} dropped\n")
        else:
            # audio-only: wait for the audio thread to finish
            threads[-1].join()
        if self.sink:
            self.sink.close()
        return 0


def main(argv: Optional[list] = None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    vo, ao = "term", "sim"
    ao_path = ao_cmd = url = None
    max_frames = duration = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-vo":
            i += 1
            vo = argv[i]
        elif a == "-ao":
            i += 1
            ao = argv[i]
            if ao.startswith("file:"):
                ao, ao_path = "file", ao[5:]
            elif ao not in ("sim", "null"):
                ao, ao_cmd = "cmd", argv[i]
        elif a == "-frames":
            i += 1
            max_frames = int(argv[i])
        elif a == "-t":
            i += 1
            duration = float(argv[i])
        elif not a.startswith("-"):
            url = a
        i += 1
    if url is None:
        sys.stderr.write(
            "usage: avplay [-vo term|null] [-ao sim|file:PATH|'CMD'] "
            "[-frames N] [-t SECS] input\n")
        return 1
    try:
        dev = hwdevice.device(device)
    except RuntimeError as e:
        sys.stderr.write(f"avplay: {e}\n")
        return 1
    try:
        return Player(url, vo, ao, ao_path, ao_cmd, max_frames,
                      duration, device=dev).run()
    except AVError as e:
        sys.stderr.write(f"avplay: {e}\n")
        return 1


def play(url: str, vo: str = "term", max_frames: Optional[int] = None,
         ao: str = "null", device="cuda") -> int:
    """Programmatic entry (kept for tests/embedding)."""
    return Player(url, vo=vo, ao=ao, max_frames=max_frames,
                  device=device).run()


if __name__ == "__main__":
    sys.exit(main())
