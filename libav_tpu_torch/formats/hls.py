"""HLS (HTTP Live Streaming, RFC 8216) demuxer (reference:
libavformat/hls.c hls_read_header/read_data segment chain).

A media playlist's segments are opened in order through the protocol
layer and chained into one byte stream feeding the inner demuxer
(MPEG-TS segments concatenate into one valid transport stream, which
is how the reference's read_data refills across segments).  Master
playlists pick the highest-BANDWIDTH variant like the reference's
default stream selection.  Live playlists (no #EXT-X-ENDLIST) refresh
the playlist when the segment window runs out and resume at the right
#EXT-X-MEDIA-SEQUENCE offset (hls.c parse_playlist re-read +
can_reload logic); a refresh that yields no new segments ends the
stream (the reference instead sleeps target-duration and retries —
a batch transcoder wants termination, a player can re-open).
"""

from __future__ import annotations

from typing import Callable, List, Optional
from urllib.parse import urljoin

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.formats.api import (FormatContext, InputFormat,
                                   register_input)
from libav_tpu_torch.formats.io import IOContext, url_open


def _resolve(base: str, uri: str) -> str:
    if "://" in uri:
        return uri                       # already absolute
    if "://" in base:
        return urljoin(base, uri)        # handles root-relative too
    if uri.startswith("/"):
        return uri                       # absolute filesystem path
    head = base.rsplit("/", 1)[0] if "/" in base else "."
    return f"{head}/{uri}"


def parse_playlist(text: str, base: str):
    """Returns (segments, variants, meta): segment URL list for a media
    playlist, or (BANDWIDTH, url) variant list for a master playlist;
    meta carries live-stream state (media sequence, endlist flag)."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines or lines[0] != "#EXTM3U":
        raise AVError(INVALIDDATA, "not an M3U8 playlist")
    segments: List[str] = []
    variants = []
    meta = {"endlist": False, "media_seq": 0, "target_duration": 0.0}
    pending_bw: Optional[int] = None
    expect_segment = False
    for ln in lines[1:]:
        if ln.startswith("#EXT-X-STREAM-INF"):
            pending_bw = 0
            for attr in ln.split(":", 1)[1].split(","):
                if attr.strip().startswith("BANDWIDTH="):
                    pending_bw = int(attr.strip().split("=", 1)[1])
        elif ln.startswith("#EXT-X-ENDLIST"):
            meta["endlist"] = True
        elif ln.startswith("#EXT-X-MEDIA-SEQUENCE"):
            meta["media_seq"] = int(ln.split(":", 1)[1])
        elif ln.startswith("#EXT-X-TARGETDURATION"):
            meta["target_duration"] = float(ln.split(":", 1)[1])
        elif ln.startswith("#EXTINF"):
            expect_segment = True
        elif ln.startswith("#EXT-X-MAP"):
            for attr in ln.split(":", 1)[1].split(","):
                if attr.strip().startswith("URI="):
                    uri = attr.strip().split("=", 1)[1].strip('"')
                    segments.insert(0, _resolve(base, uri))
        elif ln.startswith("#"):
            continue
        elif pending_bw is not None:
            variants.append((pending_bw, _resolve(base, ln)))
            pending_bw = None
        elif expect_segment:
            segments.append(_resolve(base, ln))
            expect_segment = False
    return segments, variants, meta


class _SegmentChain:
    """Forward byte stream over the segment list (hls.c read_data).
    `refill` is called when the list runs out (live playlists); it
    returns (newly appeared segment URLs, more_expected) — when
    more_expected is False (ENDLIST seen or fetch failed) the chain
    drops the callback so the stream terminates without a redundant
    playlist fetch."""

    def __init__(self, urls: List[str],
                 refill: Optional[Callable[[], tuple]] = None):
        self._urls = urls
        self._k = 0
        self._cur: Optional[IOContext] = None
        self._refill = refill
        self.pos = 0

    def read(self, n: int = -1) -> bytes:
        out = b""
        while n < 0 or len(out) < n:
            if self._cur is None:
                if self._k >= len(self._urls):
                    if self._refill is not None:
                        fresh, more = self._refill()
                        if not more:
                            self._refill = None
                        if fresh:
                            self._urls.extend(fresh)
                            continue
                        if self._refill is None:
                            break
                    break
                self._cur = url_open(self._urls[self._k], "r")
                self._k += 1
            chunk = self._cur.read(-1 if n < 0 else n - len(out))
            if not chunk:
                self._cur.close()
                self._cur = None
                continue
            out += chunk
        self.pos += len(out)
        return out

    def tell(self) -> int:
        return self.pos

    def close(self):
        if self._cur is not None:
            self._cur.close()


@register_input
class HLSDemuxer(InputFormat):
    NAME = "hls"
    LONG_NAME = "Apple HTTP Live Streaming"
    EXTENSIONS = ("m3u8", "m3u")

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        if data.startswith(b"#EXTM3U"):
            body = data[:4096]
            if (b"#EXT-X-STREAM-INF" in body or b"#EXTINF" in body
                    or b"#EXT-X-TARGETDURATION" in body):
                return 100
            return 50
        return 0

    def read_header(self, pb: IOContext):
        base = self.url or getattr(pb, "url", "")
        text = pb.read_all().decode("utf-8", "replace")
        segments, variants, meta = parse_playlist(text, base)
        self._media_url = base
        if variants and not segments:
            # master playlist: pick the highest-bandwidth variant
            best = max(variants)[1]
            self._media_url = best
            with url_open(best, "r") as vp:
                segments, _, meta = parse_playlist(
                    vp.read_all().decode("utf-8", "replace"), best)
        if not segments:
            raise AVError(INVALIDDATA, "empty HLS playlist")
        # live window bookkeeping: next expected media sequence number
        self._next_seq = meta["media_seq"] + len(segments)
        refill = None if meta["endlist"] else self._reload_playlist
        # spool the forward-only chain so the inner demuxer may seek
        # (cache.c is how the reference backs non-seekable inputs too)
        from libav_tpu_torch.formats.api import probe_input
        from libav_tpu_torch.formats.io import CacheProtocol
        chain = IOContext(
            CacheProtocol._Spool(IOContext(
                _SegmentChain(segments, refill),
                seekable=False, url=base)),
            seekable=True, url=base)
        head = chain.read(4096)
        chain.seek(0)
        cls = probe_input(head, segments[0])
        self._inner = cls()
        self._inner.url = segments[0]
        self._inner.read_header(chain)
        self.streams = self._inner.streams
        self.pb_inner = chain

    def _reload_playlist(self):
        """Re-fetch the live media playlist and return (segments that
        appeared after the ones already consumed, more_expected)
        (matched by #EXT-X-MEDIA-SEQUENCE, hls.c parse_playlist reload
        path).  more_expected=False once ENDLIST is seen, so the chain
        plays the remaining tail and terminates without another
        fetch."""
        try:
            with url_open(self._media_url, "r") as p:
                segs, _, meta = parse_playlist(
                    p.read_all().decode("utf-8", "replace"),
                    self._media_url)
        except (AVError, OSError):
            return [], False
        skip = self._next_seq - meta["media_seq"]
        fresh = segs[max(0, skip):]
        self._next_seq = meta["media_seq"] + len(segs)
        return fresh, not meta["endlist"]

    def read_packet(self) -> Packet:
        return self._inner.read_packet()

    def close(self):
        self._inner.close()
        self.pb_inner.close()
