"""AVDictionary — ordered string k/v store with match flags
(reference: libavutil/dict.h / dict.c:146 — av_dict_get/set semantics:
case-insensitive by default, MATCH_CASE, IGNORE_SUFFIX prefix matching,
APPEND/DONT_OVERWRITE write modes, multikey iteration)."""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

MATCH_CASE = 1          # AV_DICT_MATCH_CASE
IGNORE_SUFFIX = 2       # AV_DICT_IGNORE_SUFFIX: key is a prefix
DONT_OVERWRITE = 16     # AV_DICT_DONT_OVERWRITE
APPEND = 32             # AV_DICT_APPEND: concatenate to existing value
MULTIKEY = 64           # AV_DICT_MULTIKEY: allow duplicate keys


class AVDictionary:
    """Insertion-ordered multimap over (key, value) string pairs."""

    def __init__(self, items=None):
        self._items: List[Tuple[str, str]] = []
        if items:
            for k, v in (items.items() if isinstance(items, dict)
                         else items):
                self.set(k, v)

    # -- av_dict_get ---------------------------------------------------- #

    def _matches(self, key: str, want: str, flags: int) -> bool:
        if not (flags & MATCH_CASE):
            key, want = key.lower(), want.lower()
        if flags & IGNORE_SUFFIX:
            return key.startswith(want)
        return key == want

    def get(self, key: str, prev: Optional[Tuple[str, str]] = None,
            flags: int = 0) -> Optional[Tuple[str, str]]:
        """Return the (key, value) entry after `prev` matching `key`
        (reference dict.c av_dict_get iteration contract)."""
        start = 0
        if prev is not None:
            for i, it in enumerate(self._items):
                if it is prev or it == prev:
                    start = i + 1
                    break
        for it in self._items[start:]:
            if self._matches(it[0], key, flags):
                return it
        return None

    def get_value(self, key: str, default: Optional[str] = None,
                  flags: int = 0) -> Optional[str]:
        e = self.get(key, flags=flags)
        return e[1] if e else default

    # -- av_dict_set ---------------------------------------------------- #

    def set(self, key: str, value: Optional[str], flags: int = 0) -> int:
        key = str(key)
        if value is not None:
            value = str(value)
        if not (flags & MULTIKEY):
            existing = self.get(key, flags=flags & MATCH_CASE)
            if existing is not None:
                if flags & DONT_OVERWRITE:
                    return 0
                if flags & APPEND and value is not None:
                    value = existing[1] + value
                self._items.remove(existing)
        if value is None:       # deletion
            while True:
                e = self.get(key, flags=flags & MATCH_CASE)
                if e is None:
                    break
                self._items.remove(e)
            return 0
        self._items.append((key, value))
        return 0

    def set_int(self, key: str, value: int, flags: int = 0) -> int:
        return self.set(key, str(int(value)), flags)

    # -- misc (av_dict_count / copy / free analogues) -------------------- #

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        return iter(list(self._items))

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __getitem__(self, key: str) -> str:
        e = self.get(key)
        if e is None:
            raise KeyError(key)
        return e[1]

    def __setitem__(self, key: str, value: str):
        self.set(key, value)

    def copy(self, flags: int = 0) -> "AVDictionary":
        d = AVDictionary()
        d._items = list(self._items)
        return d

    def to_dict(self) -> dict:
        return {k: v for k, v in self._items}

    def parse_string(self, s: str, key_val_sep: str = "=",
                     pairs_sep: str = ":", flags: int = 0) -> int:
        """reference: av_dict_parse_string"""
        if not s:
            return 0
        for pair in s.split(pairs_sep):
            if not pair:
                continue
            if key_val_sep in pair:
                k, v = pair.split(key_val_sep, 1)
            else:
                k, v = pair, ""
            self.set(k, v, flags)
        return 0
