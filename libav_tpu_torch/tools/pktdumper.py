"""Dump demuxed packets to files / stdout listing (reference:
tools/pktdumper.c)."""

from __future__ import annotations

import sys
from typing import Optional

from libav_tpu_torch.avutil.crc import adler32
from libav_tpu_torch.formats import FormatContext


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.stderr.write("usage: pktdumper <input> [outdir]\n")
        return 1
    url = argv[0]
    outdir = argv[1] if len(argv) > 1 else None
    ic = FormatContext.open_input(url)
    for i, pkt in enumerate(ic.packets()):
        print(f"pkt {i:05d} stream={pkt.stream_index} dts={pkt.dts} "
              f"pts={pkt.pts} size={pkt.size} crc=0x{adler32(pkt.data):08x}")
        if outdir:
            with open(f"{outdir}/pkt{i:05d}.bin", "wb") as f:
                f.write(pkt.data)
    ic.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
