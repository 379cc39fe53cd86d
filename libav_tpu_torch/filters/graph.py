"""Filter + FilterGraph core (reference: libavfilter/avfilter.h:120
AVFilter, :569 AVFilterGraph, graphparser.c parse_filter chains).

The JAX package's graph (libav_tpu/filters/graph.py), copied, with one
change: a FilterGraph takes the torch device it runs on, validated
through `avutil.hwdevice.device`, "cuda" by default. The graph hands it
to every filter it builds (`Filter.device`); the filters that need a
device read it there: hwupload uploads to it, the sources put their
frames on it. The video filters compute on the device of the frame's
planes, so a decoder's frames stay where the decoder put them.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Type

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.opt import OptionedObject

_FILTERS: Dict[str, Type["Filter"]] = {}


def register_filter(cls):
    _FILTERS[cls.NAME] = cls
    return cls


def get_filter(name: str) -> Type["Filter"]:
    if name not in _FILTERS:
        raise AVError(EINVAL, f"no such filter: {name!r}")
    return _FILTERS[name]


def list_filters() -> List[str]:
    return sorted(_FILTERS)


class Filter(OptionedObject):
    """reference: avfilter.h:120 AVFilter + AVFilterContext merged.

    Subclasses implement filter_frame(frame) -> List[Frame]; flush() ->
    List[Frame] for buffered filters (fps, trim...). `device` is the
    graph's device (a spec for `hwdevice.device` when the filter is built
    alone), read by the filters that place frames: hwupload and the
    sources.
    """

    NAME = "null"
    TYPE = "video"    # or "audio"

    def __init__(self, args: str = "", device="cuda", **kwopts):
        self.init_defaults()
        self.device = device
        self.next: Optional[Filter] = None
        if args:
            self._parse_args(args)
        for k, v in kwopts.items():
            self.set_opt(k, v)
        self._configured = False
        self.init()

    def _parse_args(self, args: str):
        """'w=320:h=240' or positional '320:240'
        (reference: graphparser.c option syntax)."""
        table = [o for o in self._opt_table().values() if o.type != "const"]
        for i, part in enumerate(args.split(":")):
            if not part:
                continue
            if "=" in part:
                k, v = part.split("=", 1)
                self.set_opt(k.strip(), v.strip())
            else:
                if i >= len(table):
                    raise AVError(EINVAL, f"{self.NAME}: too many args")
                self.set_opt(table[i].name, part)

    def init(self):
        """Called once after options are set (AVFilter.init stand-in)."""

    def configure(self, frame: Frame):
        """Called once with the first frame (link negotiation stand-in)."""

    def filter_frame(self, frame: Frame) -> List[Frame]:
        return [frame]

    def flush(self) -> List[Frame]:
        return []

    def push(self, frame: Frame) -> List[Frame]:
        """reference: avfilter.c:643 ff_filter_frame"""
        if not self._configured:
            self.configure(frame)
            self._configured = True
        out = self.filter_frame(frame)
        if self.next is None:
            return out
        result = []
        for f in out:
            result.extend(self.next.push(f))
        return result

    def push_eof(self) -> List[Frame]:
        out = self.flush()
        if self.next is None:
            return out
        result = []
        for f in out:
            result.extend(self.next.push(f))
        result.extend(self.next.push_eof())
        return result


class _Node:
    """A filter instance in a DAG graph with pad link queues."""

    def __init__(self, flt: Filter):
        self.filter = flt
        self.in_links: List["_Link"] = []
        self.out_links: List["_Link"] = []
        self.flushed = False


class _Link:
    """reference: avfilter.h AVFilterLink — a FIFO between two pads."""

    def __init__(self, src: Optional[_Node], dst: Optional[_Node] = None):
        self.src = src
        self.dst = dst
        self.queue: List[Frame] = []


class FilterGraph:
    """reference: avfiltergraph.c AVFilterGraph + graphparser.c.

    Linear chains ('a,b,c') run the fast single-path push; descriptions
    with ';' chains or '[label]' pads build a full DAG
    (parse_filter/link_filter_inouts semantics): unlabeled neighbors in
    a chain connect sequentially, '[x]' outputs match later '[x]'
    inputs, the one unmatched input pad is the graph source and the one
    unmatched output pad is the sink.  Multi-output nodes (split) fan
    frames out to every out link; multi-input filters (overlay) receive
    pad>=1 frames via push_secondary.

    device: where the graph runs ("cpu", "cuda", "cuda:N"; validated
    here, so asking for CUDA without it raises RuntimeError)."""

    def __init__(self, description: str = "", device="cuda"):
        self.device = hwdevice.device(device)
        self.filters: List[Filter] = []
        self._nodes: List[_Node] = []
        self._src_link: Optional[_Link] = None
        self._sink_link: Optional[_Link] = None
        if description:
            self.parse(description)

    # -- parsing ----------------------------------------------------- #

    def parse(self, description: str):
        if ";" in description or "[" in description:
            self._parse_dag(description)
            return
        for chunk in _split_chain(description):
            m = re.match(r"([a-zA-Z_][a-zA-Z_0-9]*)(?:=(.*))?$", chunk.strip())
            if not m:
                raise AVError(EINVAL, f"cannot parse filter spec {chunk!r}")
            name, args = m.group(1), m.group(2) or ""
            self.add(get_filter(name)(args, device=self.device))

    _PAD_RE = re.compile(r"\s*\[\s*([^\]]+)\s*\]")
    _FLT_RE = re.compile(r"\s*([a-zA-Z_][a-zA-Z_0-9]*)\s*(?:=((?:[^\[,;]|"
                         r"\\.)*))?")

    def _parse_dag(self, description: str):
        pending: Dict[str, tuple] = {}     # label -> (node, out_pad_no)
        open_inputs: List[tuple] = []      # (node, label or None)
        open_outputs: List[_Node] = []
        for chain in description.split(";"):
            prev: Optional[_Node] = None
            for chunk in _split_chain(chain):
                s = chunk.strip()
                in_labels = []
                while True:
                    m = self._PAD_RE.match(s)
                    if not m:
                        break
                    in_labels.append(m.group(1))
                    s = s[m.end():]
                m = self._FLT_RE.match(s)
                if not m:
                    raise AVError(EINVAL,
                                  f"cannot parse filter spec {chunk!r}")
                name, args = m.group(1), (m.group(2) or "").strip()
                s = s[m.end():]
                out_labels = []
                while True:
                    m2 = self._PAD_RE.match(s)
                    if not m2:
                        break
                    out_labels.append(m2.group(1))
                    s = s[m2.end():]
                if s.strip():
                    raise AVError(EINVAL, f"junk after filter: {s!r}")
                node = _Node(get_filter(name)(args, device=self.device))
                self._nodes.append(node)
                self.filters.append(node.filter)
                # connect inputs: labels, else previous in chain
                if in_labels:
                    for lbl in in_labels:
                        if lbl in pending:
                            src, _ = pending.pop(lbl)
                            self._link(src, node)
                        else:
                            open_inputs.append((node, lbl))
                elif prev is not None:
                    self._link(prev, node)
                else:
                    open_inputs.append((node, None))
                for lbl in out_labels:
                    pending[lbl] = (node, len(node.out_links))
                # labeled outputs end the implicit chain link
                prev = node if not out_labels else None
            if prev is not None:
                open_outputs.append(prev)
        # resolve forward references: an input label may name an output
        # declared in a later chain — second pass over open inputs
        unresolved = []
        for node, lbl in open_inputs:
            if lbl is not None and lbl in pending:
                src, _ = pending.pop(lbl)
                self._link(src, node)
            else:
                unresolved.append((node, lbl))
        # remaining pending labels are graph outputs; unresolved inputs
        # are graph sources
        if len(unresolved) != 1:
            raise AVError(EINVAL, "graph needs exactly one open input, "
                                  f"got {len(unresolved)}")
        src_node = unresolved[0][0]
        self._src_link = _Link(None, src_node)
        src_node.in_links.insert(0, self._src_link)
        sinks = [n for n, _ in pending.values()] + open_outputs
        if len(sinks) != 1:
            raise AVError(EINVAL, "graph needs exactly one open output, "
                                  f"got {len(sinks)}")
        self._sink_link = _Link(sinks[0], None)
        sinks[0].out_links.append(self._sink_link)

    @staticmethod
    def _link(src: _Node, dst: _Node):
        ln = _Link(src, dst)
        src.out_links.append(ln)
        dst.in_links.append(ln)

    def add(self, f: Filter) -> Filter:
        if self.filters:
            self.filters[-1].next = f
        self.filters.append(f)
        return f

    # -- execution ----------------------------------------------------#

    def _fan_out(self, node: _Node, frames: List[Frame]):
        # channelsplit-style filters return one distinct frame per
        # output pad instead of fanning a single frame to every link
        if getattr(node.filter, "PER_PAD_OUTPUT", False) and \
                len(node.out_links) > 1 and \
                len(frames) == len(node.out_links):
            for f, ln in zip(frames, node.out_links):
                ln.queue.append(f)
            return
        for f in frames:
            for i, ln in enumerate(node.out_links):
                if i == 0:
                    ln.queue.append(f)
                else:
                    dup = f.clone_props()
                    dup.planes = list(f.planes)
                    ln.queue.append(dup)

    def _run_dag(self) -> List[Frame]:
        # nodes were appended in parse order, which is topological for
        # graphparser chains (inputs always declared before use)
        progress = True
        while progress:
            progress = False
            for node in self._nodes:
                # secondary pads (overlay) drain first
                for ln in node.in_links[1:]:
                    while ln.queue:
                        node.filter.push_secondary(ln.queue.pop(0))
                        progress = True
                main = node.in_links[0] if node.in_links else None
                while main is not None and main.queue:
                    frame = main.queue.pop(0)
                    flt = node.filter
                    if not flt._configured:
                        flt.configure(frame)
                        flt._configured = True
                    self._fan_out(node, flt.filter_frame(frame))
                    progress = True
        out = self._sink_link.queue
        self._sink_link.queue = []
        return out

    def push(self, frame: Frame) -> List[Frame]:
        if self._src_link is not None:
            self._src_link.queue.append(frame)
            return self._run_dag()
        if not self.filters:
            return [frame]
        return self.filters[0].push(frame)

    def push_eof(self) -> List[Frame]:
        if self._src_link is not None:
            out = self._run_dag()
            for node in self._nodes:       # topological flush
                self._fan_out(node, node.filter.flush())
                out.extend(self._run_dag())
            return out
        if not self.filters:
            return []
        return self.filters[0].push_eof()


def _split_chain(desc: str) -> List[str]:
    """Split on commas not inside quotes/escapes."""
    parts, cur, esc = [], "", False
    for ch in desc:
        if esc:
            cur += ch
            esc = False
        elif ch == "\\":
            esc = True
        elif ch == ",":
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    return [p for p in parts if p.strip()]
