"""Running the JAX package's host code against the port's names.

The port reuses the JAX package's host code as it is. Where that code
reaches the device, it does so through a module global or an import made
inside a function body, so the port hands it other names instead of
copying it:
  - `rebind(fn, names)`: fn's own code with other globals (the decoders'
    device methods, avprobe's trial decode);
  - `host_builtins(replace, refuse)`: an `__import__` that answers chosen
    modules' names with the port's, or refuses a module that the port
    has not ported yet (put into such globals as `__builtins__`);
  - `load_host_module(ref, name, ...)`: a module's source executed again
    as a module of its own with that import (the CLI tools).
The JAX package's own functions and modules are never modified.
"""

from __future__ import annotations

import builtins
import importlib.util
import sys
import types
from typing import Dict, Mapping

from libav_tpu.avutil.error import AVError, PATCHWELCOME


def rebind(fn, names: dict, instance=None):
    """A function with fn's code and `names` as its globals, bound to
    instance if one is given."""
    f = types.FunctionType(fn.__code__, names, fn.__name__, fn.__defaults__)
    return f if instance is None else types.MethodType(f, instance)


def host_builtins(replace: Mapping[str, Dict[str, object]] = None,
                  refuse: Mapping[str, str] = None) -> dict:
    """Builtins whose `__import__` answers `from <module> import ...` for
    each module in `replace` with the real module's names updated by
    replace[module], and raises AVError(PATCHWELCOME, refuse[module]) for
    each module in `refuse`, before importing it. Every other import is
    the real one."""
    replace, refuse = replace or {}, refuse or {}

    def import_(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name in refuse:
            raise AVError(PATCHWELCOME, refuse[name])
        mod = builtins.__import__(name, globals, locals, fromlist, level)
        if level == 0 and fromlist and name in replace:
            return types.SimpleNamespace(**{**vars(mod), **replace[name]})
        return mod
    return dict(vars(builtins), __import__=import_)


def load_host_module(ref: types.ModuleType, name: str,
                     **imports) -> types.ModuleType:
    """Execute ref's source file again as the module `name`, with
    `host_builtins(**imports)` for every import it makes, at load time and
    inside its functions. ref itself is untouched."""
    spec = importlib.util.spec_from_file_location(name, ref.__file__)
    mod = importlib.util.module_from_spec(spec)
    mod.__builtins__ = host_builtins(**imports)
    sys.modules[name] = mod          # dataclasses resolve annotations here
    spec.loader.exec_module(mod)
    return mod
