"""Arithmetic expression evaluator (reference: libavutil/eval.c, 800 LoC).

Used by rate control's rc_eq model (reference: libavcodec/ratecontrol.c:253
av_expr_eval of e.g. "tex^qComp") and by filter arguments. Supports the
same core grammar: + - * / ^ ( ), named constants/variables, and the
function set rate control and common filters need.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence

from libav_tpu_torch.avutil.error import AVError, EINVAL

_TOKEN_RE = re.compile(
    r"\s*(?:(\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|([A-Za-z_][A-Za-z_0-9.]*)|(\*\*|[-+*/^(),<>]|==|!=|>=|<=))"
)

_FUNCS1: Dict[str, Callable[[float], float]] = {
    "abs": abs, "sqrt": math.sqrt, "exp": math.exp,
    "log": lambda x: math.log(x) if x > 0 else -1e308,
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "floor": math.floor, "ceil": math.ceil, "trunc": math.trunc,
    "round": round, "sinh": math.sinh, "cosh": math.cosh, "tanh": math.tanh,
    "squish": lambda x: 1.0 / (1.0 + math.exp(4 * x)),
    "gauss": lambda x: math.exp(-x * x / 2) / math.sqrt(2 * math.pi),
    "isnan": lambda x: 1.0 if math.isnan(x) else 0.0,
    "not": lambda x: 1.0 if x == 0 else 0.0,
}

_FUNCS2: Dict[str, Callable[[float, float], float]] = {
    "max": max, "min": min, "pow": lambda a, b: _pow(a, b),
    "hypot": math.hypot, "mod": lambda a, b: math.fmod(a, b),
    "gt": lambda a, b: 1.0 if a > b else 0.0,
    "gte": lambda a, b: 1.0 if a >= b else 0.0,
    "lt": lambda a, b: 1.0 if a < b else 0.0,
    "lte": lambda a, b: 1.0 if a <= b else 0.0,
    "eq": lambda a, b: 1.0 if a == b else 0.0,
}


def _pow(a: float, b: float) -> float:
    try:
        r = a ** b
        if isinstance(r, complex):
            return float('nan')
        return r
    except (OverflowError, ValueError, ZeroDivisionError):
        return float('nan')


class _Parser:
    def __init__(self, tokens: List, variables: Dict[str, float],
                 funcs1: Dict, funcs2: Dict):
        self.toks = tokens
        self.pos = 0
        self.vars = variables
        self.funcs1 = funcs1
        self.funcs2 = funcs2

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise AVError(EINVAL, f"expected {t!r}, got {got!r}")

    # grammar: expr := term (('+'|'-') term)*
    #          term := pow (('*'|'/') pow)*
    #          pow  := unary ('^' pow)?          (right assoc)
    #          unary := ('-'|'+')* primary
    #          primary := NUM | NAME | NAME '(' args ')' | '(' expr ')'
    def expr(self) -> float:
        v = self.term()
        while self.peek() in ("+", "-"):
            op = self.next()
            r = self.term()
            v = v + r if op == "+" else v - r
        return v

    def term(self) -> float:
        v = self.power()
        while self.peek() in ("*", "/"):
            op = self.next()
            r = self.power()
            if op == "*":
                v = v * r
            else:
                v = v / r if r != 0 else (float('inf') if v > 0 else float('-inf') if v < 0 else float('nan'))
        return v

    def power(self) -> float:
        v = self.unary()
        if self.peek() in ("^", "**"):
            self.next()
            return _pow(v, self.power())
        return v

    def unary(self) -> float:
        sign = 1.0
        while self.peek() in ("-", "+"):
            if self.next() == "-":
                sign = -sign
        return sign * self.primary()

    def primary(self) -> float:
        t = self.next()
        if t is None:
            raise AVError(EINVAL, "unexpected end of expression")
        if isinstance(t, float):
            return t
        if t == "(":
            v = self.expr()
            self.expect(")")
            return v
        if isinstance(t, str) and (t[0].isalpha() or t[0] == "_"):
            if self.peek() == "(":
                self.next()
                args = [self.expr()]
                while self.peek() == ",":
                    self.next()
                    args.append(self.expr())
                self.expect(")")
                if len(args) == 1 and t in self.funcs1:
                    return float(self.funcs1[t](args[0]))
                if len(args) == 2 and t in self.funcs2:
                    return float(self.funcs2[t](args[0], args[1]))
                if t == "if":
                    return args[1] if args[0] != 0 else (args[2] if len(args) > 2 else 0.0)
                raise AVError(EINVAL, f"unknown function {t}/{len(args)}")
            if t in self.vars:
                return float(self.vars[t])
            consts = {"PI": math.pi, "E": math.e, "PHI": (1 + 5 ** 0.5) / 2}
            if t in consts:
                return consts[t]
            raise AVError(EINVAL, f"unknown identifier {t!r}")
        raise AVError(EINVAL, f"unexpected token {t!r}")


def _tokenize(s: str) -> List:
    toks: List = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise AVError(EINVAL, f"bad expression at {s[pos:]!r}")
        num, name, op = m.groups()
        if num is not None:
            toks.append(float(m.group(0)))
        elif name is not None:
            toks.append(name)
        else:
            toks.append(op)
        pos = m.end()
    return toks


def expr_eval(expression: str, variables: Optional[Dict[str, float]] = None,
              funcs1: Optional[Dict] = None, funcs2: Optional[Dict] = None) -> float:
    """reference: eval.c av_expr_parse_and_eval"""
    f1 = dict(_FUNCS1)
    f2 = dict(_FUNCS2)
    if funcs1:
        f1.update(funcs1)
    if funcs2:
        f2.update(funcs2)
    p = _Parser(_tokenize(expression), variables or {}, f1, f2)
    v = p.expr()
    if p.peek() is not None:
        raise AVError(EINVAL, f"trailing tokens in {expression!r}")
    return v
