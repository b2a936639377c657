"""A small Lua 5.1 subset interpreter for server-side EVAL (counterpart of
`redisson_tpu.interop.mini_lua`; pure Python).

Redis executes coordination logic (locks, semaphores, map-cache TTL,
batched eviction) as atomic server-side Lua scripts — the reference ships
dozens of them (`RedissonLock.java:236-252`, `RedissonMapCache.java:75-87`,
`RedissonSemaphore.java`, `EvictionScheduler.java:47-115`).  The in-process
fake server (`fake_server.py`) is this repo's test oracle, so it needs a
genuine EVAL: this module implements the Lua fragment those scripts are
written in — a tokenizer, recursive-descent parser and tree-walking
evaluator.  It is NOT a script-recognizer; any script inside the subset
runs, including user RScript code.

Supported subset
  * statements: ``local``, assignment, ``if/elseif/else``, numeric ``for``,
    generic ``for .. in pairs/ipairs``, ``while``, ``repeat/until``,
    ``break``, ``return``, bare function-call statements;
  * expressions: full operator precedence (``or and  < > <= >= ~= ==  ..
    + -  * / %  not - #  ^``), parentheses, table constructors
    (``{a, b}`` and ``{k = v}``), indexing (``t[i]``, ``t.k``);
  * stdlib: ``tonumber tostring type pairs ipairs unpack error assert``,
    ``table.insert/remove/getn``, ``string.sub/len/rep/lower/upper/format``
    (``%s %d %f``), ``math.floor/ceil/max/min/huge``,
    ``redis.call/pcall/status_reply/error_reply``, ``KEYS``, ``ARGV``;
  * values: nil, boolean, number (Python float; integral rendering like
    Lua 5.1), string (Python ``bytes`` — binary-safe, as on a real server),
    table (``LuaTable``: dict with a 1-based array part).

Redis<->Lua conversions follow the real server's documented rules
(redis.io EVAL docs): RESP integer -> number, bulk -> string, nil bulk ->
``false``, status -> ``{ok=...}``, array -> table; and on return: number
-> integer (truncated), string -> bulk, true -> 1, false/nil -> nil bulk,
table -> array up to the first nil.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["LuaError", "LuaTable", "run_script", "lua_to_resp_value"]


class LuaError(Exception):
    """A raised Lua error (error(), redis.call failure, type error)."""

    def __init__(self, message):
        self.lua_message = message
        super().__init__(
            message.decode("utf-8", "replace") if isinstance(message, bytes) else str(message)
        )


class LuaTable:
    """A Lua table: hash part + the derived 1-based sequence length."""

    __slots__ = ("hash",)

    def __init__(self, array: Optional[List[Any]] = None):
        self.hash: Dict[Any, Any] = {}
        if array:
            for i, v in enumerate(array, start=1):
                if v is not None:
                    self.hash[float(i)] = v

    def get(self, key):
        return self.hash.get(_normkey(key))

    def set(self, key, value):
        key = _normkey(key)
        if key is None:
            raise LuaError(b"table index is nil")
        if value is None:
            self.hash.pop(key, None)
        else:
            self.hash[key] = value

    def length(self) -> int:
        # Lua 5.1 border semantics degenerate to "count from 1" for the
        # sequences scripts build.
        n = 0
        while float(n + 1) in self.hash:
            n += 1
        return n

    def array(self) -> List[Any]:
        return [self.hash[float(i)] for i in range(1, self.length() + 1)]


def _normkey(key):
    # Lua: t[1] and t[1.0] are the same slot; strings are distinct.
    if isinstance(key, bool):
        return key
    if isinstance(key, (int, float)):
        return float(key)
    return key


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for", "function",
    "if", "in", "local", "nil", "not", "or", "repeat", "return", "then",
    "true", "until", "while",
}

_TOKEN_RE = re.compile(
    rb"""
    (?P<ws>\s+|--\[\[.*?\]\]|--[^\n]*)
  | (?P<number>0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_]\w*)
  | (?P<string>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<op>\.\.\.|\.\.|==|~=|<=|>=|[-+*/%^#<>=(){}\[\];:,.])
    """,
    re.VERBOSE | re.DOTALL,
)

_ESCAPES = {
    b"n": b"\n", b"t": b"\t", b"r": b"\r", b"a": b"\a", b"b": b"\b",
    b"f": b"\f", b"v": b"\v", b"\\": b"\\", b"'": b"'", b'"': b'"',
    b"\n": b"\n", b"0": b"\x00",
}


def _unescape(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt.isdigit():
                j = i + 1
                while j < len(raw) and j < i + 4 and raw[j : j + 1].isdigit():
                    j += 1
                out.append(int(raw[i + 1 : j]))
                i = j
                continue
            out += _ESCAPES.get(nxt, nxt)
            i += 2
            continue
        out += c
        i += 1
    return bytes(out)


def _tokenize(src: bytes) -> List[Tuple[str, Any]]:
    tokens: List[Tuple[str, Any]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise LuaError(b"unexpected character at position %d" % pos)
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "number":
            if text[:2] in (b"0x", b"0X"):
                tokens.append(("number", float(int(text, 16))))
            else:
                tokens.append(("number", float(text)))
        elif kind == "name":
            name = text.decode()
            if name in _KEYWORDS:
                tokens.append((name, name))
            else:
                tokens.append(("name", name))
        elif kind == "string":
            tokens.append(("string", _unescape(text[1:-1])))
        else:
            tokens.append((text.decode(), text.decode()))
    tokens.append(("<eof>", None))
    return tokens


# ---------------------------------------------------------------------------
# Parser — produces tuple-based AST nodes
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: List[Tuple[str, Any]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> str:
        return self.toks[self.i][0]

    def next(self) -> Tuple[str, Any]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str) -> Any:
        t, v = self.next()
        if t != kind:
            raise LuaError(f"'{kind}' expected near '{t}'".encode())
        return v

    def accept(self, kind: str) -> bool:
        if self.peek() == kind:
            self.i += 1
            return True
        return False

    # -- statements ---------------------------------------------------------

    def parse_chunk(self, terminators=("<eof>",)) -> list:
        stats = []
        while True:
            while self.accept(";"):
                pass
            if self.peek() in terminators:
                return stats
            stats.append(self.parse_statement())
            if stats[-1][0] in ("return", "break"):
                while self.accept(";"):
                    pass
                if self.peek() not in terminators:
                    raise LuaError(b"unreachable code after return/break")
                return stats

    def parse_statement(self):
        t = self.peek()
        if t == "local":
            self.next()
            names = [self.expect("name")]
            while self.accept(","):
                names.append(self.expect("name"))
            exprs = []
            if self.accept("="):
                exprs = self.parse_exprlist()
            return ("local", names, exprs)
        if t == "if":
            return self.parse_if()
        if t == "while":
            self.next()
            cond = self.parse_expr()
            self.expect("do")
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("while", cond, body)
        if t == "repeat":
            self.next()
            body = self.parse_chunk(("until",))
            self.expect("until")
            cond = self.parse_expr()
            return ("repeat", body, cond)
        if t == "for":
            return self.parse_for()
        if t == "return":
            self.next()
            if self.peek() in ("<eof>", "end", "else", "elseif", "until", ";"):
                return ("return", None)
            return ("return", self.parse_expr())
        if t == "break":
            self.next()
            return ("break",)
        if t == "do":
            self.next()
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("do", body)
        # expression statement: function call or assignment
        expr = self.parse_prefix_expr()
        if self.peek() in ("=", ","):
            targets = [expr]
            while self.accept(","):
                targets.append(self.parse_prefix_expr())
            self.expect("=")
            exprs = self.parse_exprlist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    raise LuaError(b"cannot assign to this expression")
            return ("assign", targets, exprs)
        if expr[0] != "call":
            raise LuaError(b"syntax error: expression is not a statement")
        return ("callstat", expr)

    def parse_if(self):
        self.expect("if")
        clauses = []
        cond = self.parse_expr()
        self.expect("then")
        body = self.parse_chunk(("elseif", "else", "end"))
        clauses.append((cond, body))
        while self.peek() == "elseif":
            self.next()
            c = self.parse_expr()
            self.expect("then")
            b = self.parse_chunk(("elseif", "else", "end"))
            clauses.append((c, b))
        els = None
        if self.accept("else"):
            els = self.parse_chunk(("end",))
        self.expect("end")
        return ("if", clauses, els)

    def parse_for(self):
        self.expect("for")
        name1 = self.expect("name")
        if self.accept("="):
            start = self.parse_expr()
            self.expect(",")
            stop = self.parse_expr()
            step = ("number", 1.0)
            if self.accept(","):
                step = self.parse_expr()
            self.expect("do")
            body = self.parse_chunk(("end",))
            self.expect("end")
            return ("fornum", name1, start, stop, step, body)
        names = [name1]
        while self.accept(","):
            names.append(self.expect("name"))
        self.expect("in")
        iterexpr = self.parse_expr()
        self.expect("do")
        body = self.parse_chunk(("end",))
        self.expect("end")
        return ("forin", names, iterexpr, body)

    # -- expressions --------------------------------------------------------

    def parse_exprlist(self) -> list:
        exprs = [self.parse_expr()]
        while self.accept(","):
            exprs.append(self.parse_expr())
        return exprs

    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        left = self.parse_and()
        while self.peek() == "or":
            self.next()
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_cmp()
        while self.peek() == "and":
            self.next()
            left = ("and", left, self.parse_cmp())
        return left

    def parse_cmp(self):
        left = self.parse_concat()
        while self.peek() in ("<", ">", "<=", ">=", "~=", "=="):
            op = self.next()[0]
            left = ("binop", op, left, self.parse_concat())
        return left

    def parse_concat(self):
        # right-associative
        left = self.parse_add()
        if self.peek() == "..":
            self.next()
            return ("binop", "..", left, self.parse_concat())
        return left

    def parse_add(self):
        left = self.parse_mul()
        while self.peek() in ("+", "-"):
            op = self.next()[0]
            left = ("binop", op, left, self.parse_mul())
        return left

    def parse_mul(self):
        left = self.parse_unary()
        while self.peek() in ("*", "/", "%"):
            op = self.next()[0]
            left = ("binop", op, left, self.parse_unary())
        return left

    def parse_unary(self):
        t = self.peek()
        if t == "not":
            self.next()
            return ("not", self.parse_unary())
        if t == "-":
            self.next()
            return ("neg", self.parse_unary())
        if t == "#":
            self.next()
            return ("len", self.parse_unary())
        return self.parse_pow()

    def parse_pow(self):
        base = self.parse_primary()
        if self.peek() == "^":
            self.next()
            return ("binop", "^", base, self.parse_unary())
        return base

    def parse_primary(self):
        t, v = self.toks[self.i]
        if t == "number":
            self.next()
            return ("number", v)
        if t == "string":
            self.next()
            return ("string", v)
        if t == "nil":
            self.next()
            return ("nil",)
        if t == "true":
            self.next()
            return ("true",)
        if t == "false":
            self.next()
            return ("false",)
        if t == "{":
            return self.parse_table()
        return self.parse_prefix_expr()

    def parse_prefix_expr(self):
        t, v = self.next()
        if t == "(":
            expr = self.parse_expr()
            self.expect(")")
            node = ("paren", expr)
        elif t == "name":
            node = ("name", v)
        else:
            raise LuaError(f"unexpected symbol near '{t}'".encode())
        # suffixes: .name  [expr]  (args)  'str'  {table}  :method(args)
        while True:
            nt = self.peek()
            if nt == ".":
                self.next()
                node = ("index", node, ("string", self.expect("name").encode()))
            elif nt == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                node = ("index", node, idx)
            elif nt == "(":
                self.next()
                args = [] if self.peek() == ")" else self.parse_exprlist()
                self.expect(")")
                node = ("call", node, args)
            elif nt == "string":
                _, s = self.next()
                node = ("call", node, [("string", s)])
            else:
                return node

    def parse_table(self):
        self.expect("{")
        array: list = []
        pairs: list = []
        while self.peek() != "}":
            if self.peek() == "[":
                self.next()
                k = self.parse_expr()
                self.expect("]")
                self.expect("=")
                pairs.append((k, self.parse_expr()))
            elif (
                self.toks[self.i][0] == "name" and self.toks[self.i + 1][0] == "="
            ):
                k = ("string", self.expect("name").encode())
                self.expect("=")
                pairs.append((k, self.parse_expr()))
            else:
                array.append(self.parse_expr())
            if not (self.accept(",") or self.accept(";")):
                break
        self.expect("}")
        return ("table", array, pairs)


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


def _truthy(v) -> bool:
    return v is not None and v is not False


def _tonumber(v, base=None):
    if base is not None:
        try:
            return float(int(_tostr(v), int(base)))
        except (ValueError, TypeError):
            return None
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, bytes):
        try:
            s = v.strip()
            if s[:2].lower() == b"0x":
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return None
    return None


def _numfmt(x: float) -> bytes:
    if x != x or x in (math.inf, -math.inf):
        return {math.inf: b"inf", -math.inf: b"-inf"}.get(x, b"nan")
    if x == int(x) and abs(x) < 1e15:
        return b"%d" % int(x)
    return repr(x).encode()


def _tostr(v) -> bytes:
    if v is None:
        return b"nil"
    if v is True:
        return b"true"
    if v is False:
        return b"false"
    if isinstance(v, (int, float)):
        return _numfmt(float(v))
    if isinstance(v, bytes):
        return v
    if isinstance(v, LuaTable):
        return b"table: 0x%x" % id(v)
    return str(v).encode()


def _lua_type(v) -> bytes:
    if v is None:
        return b"nil"
    if isinstance(v, bool):
        return b"boolean"
    if isinstance(v, (int, float)):
        return b"number"
    if isinstance(v, bytes):
        return b"string"
    if isinstance(v, LuaTable):
        return b"table"
    if callable(v):
        return b"function"
    return b"userdata"


def _arith_operand(v, op: str) -> float:
    n = _tonumber(v)
    if n is None:
        raise LuaError(
            b"attempt to perform arithmetic (%s) on a %s value"
            % (op.encode(), _lua_type(v))
        )
    return n


class _Env:
    """Lexical scope chain."""

    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Env"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def lookup(self, name: str) -> Optional["_Env"]:
        env = self
        while env is not None:
            if name in env.vars:
                return env
            env = env.parent
        return None

    def get(self, name: str):
        env = self.lookup(name)
        return env.vars[name] if env is not None else None

    def set(self, name: str, value) -> None:
        env = self.lookup(name)
        (env or self._root()).vars[name] = value

    def declare(self, name: str, value) -> None:
        self.vars[name] = value

    def _root(self) -> "_Env":
        env = self
        while env.parent is not None:
            env = env.parent
        return env


class _Interp:
    def __init__(self, globals_env: _Env, max_steps: int = 5_000_000):
        self.globals = globals_env
        self.steps = 0
        self.max_steps = max_steps

    def _tick(self):
        self.steps += 1
        if self.steps > self.max_steps:
            raise LuaError(b"script exceeded execution budget")

    # -- statements ---------------------------------------------------------

    def exec_chunk(self, stats, env: _Env) -> None:
        for st in stats:
            self.exec_stat(st, env)

    def exec_stat(self, st, env: _Env) -> None:
        self._tick()
        op = st[0]
        if op == "local":
            _, names, exprs = st
            vals = [self.eval(e, env) for e in exprs]
            for i, n in enumerate(names):
                env.declare(n, vals[i] if i < len(vals) else None)
        elif op == "assign":
            _, targets, exprs = st
            vals = [self.eval(e, env) for e in exprs]
            for i, tgt in enumerate(targets):
                val = vals[i] if i < len(vals) else None
                if tgt[0] == "name":
                    env.set(tgt[1], val)
                else:  # index
                    obj = self.eval(tgt[1], env)
                    if not isinstance(obj, LuaTable):
                        raise LuaError(
                            b"attempt to index a %s value" % _lua_type(obj)
                        )
                    obj.set(self.eval(tgt[2], env), val)
        elif op == "callstat":
            self.eval(st[1], env)
        elif op == "if":
            _, clauses, els = st
            for cond, body in clauses:
                if _truthy(self.eval(cond, env)):
                    self.exec_chunk(body, _Env(env))
                    return
            if els is not None:
                self.exec_chunk(els, _Env(env))
        elif op == "while":
            _, cond, body = st
            while _truthy(self.eval(cond, env)):
                self._tick()
                try:
                    self.exec_chunk(body, _Env(env))
                except _Break:
                    break
        elif op == "repeat":
            _, body, cond = st
            while True:
                self._tick()
                inner = _Env(env)
                try:
                    self.exec_chunk(body, inner)
                except _Break:
                    break
                if _truthy(self.eval(cond, inner)):
                    break
        elif op == "fornum":
            _, name, e1, e2, e3, body = st
            i = _arith_operand(self.eval(e1, env), "for")
            stop = _arith_operand(self.eval(e2, env), "for")
            step = _arith_operand(self.eval(e3, env), "for")
            if step == 0:
                raise LuaError(b"'for' step is zero")
            while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                self._tick()
                inner = _Env(env)
                inner.declare(name, i)
                try:
                    self.exec_chunk(body, inner)
                except _Break:
                    break
                i += step
        elif op == "forin":
            _, names, iterexpr, body = st
            seq = self.eval(iterexpr, env)
            for k, v in seq if isinstance(seq, list) else []:
                self._tick()
                inner = _Env(env)
                inner.declare(names[0], k)
                if len(names) > 1:
                    inner.declare(names[1], v)
                try:
                    self.exec_chunk(body, inner)
                except _Break:
                    break
        elif op == "do":
            self.exec_chunk(st[1], _Env(env))
        elif op == "return":
            raise _Return(None if st[1] is None else self.eval(st[1], env))
        elif op == "break":
            raise _Break()
        else:  # pragma: no cover
            raise LuaError(b"unknown statement")

    # -- expressions --------------------------------------------------------

    def eval(self, e, env: _Env):
        self._tick()
        op = e[0]
        if op == "number":
            return e[1]
        if op == "string":
            return e[1]
        if op == "nil":
            return None
        if op == "true":
            return True
        if op == "false":
            return False
        if op == "name":
            return env.get(e[1])
        if op == "paren":
            return self.eval(e[1], env)
        if op == "index":
            obj = self.eval(e[1], env)
            if not isinstance(obj, LuaTable):
                raise LuaError(b"attempt to index a %s value" % _lua_type(obj))
            return obj.get(self.eval(e[2], env))
        if op == "call":
            fn = self.eval(e[1], env)
            if not callable(fn):
                raise LuaError(b"attempt to call a %s value" % _lua_type(fn))
            args = [self.eval(a, env) for a in e[2]]
            return fn(*args)
        if op == "and":
            left = self.eval(e[1], env)
            return self.eval(e[2], env) if _truthy(left) else left
        if op == "or":
            left = self.eval(e[1], env)
            return left if _truthy(left) else self.eval(e[2], env)
        if op == "not":
            return not _truthy(self.eval(e[1], env))
        if op == "neg":
            return -_arith_operand(self.eval(e[1], env), "-")
        if op == "len":
            v = self.eval(e[1], env)
            if isinstance(v, bytes):
                return float(len(v))
            if isinstance(v, LuaTable):
                return float(v.length())
            raise LuaError(b"attempt to get length of a %s value" % _lua_type(v))
        if op == "table":
            _, array, pairs = e
            t = LuaTable([self.eval(a, env) for a in array])
            for k, v in pairs:
                t.set(self.eval(k, env), self.eval(v, env))
            return t
        if op == "binop":
            return self.binop(e[1], self.eval(e[2], env), self.eval(e[3], env))
        raise LuaError(b"unknown expression")  # pragma: no cover

    def binop(self, op: str, a, b):
        if op == "..":
            if not isinstance(a, (bytes, int, float)) or isinstance(a, bool):
                raise LuaError(b"attempt to concatenate a %s value" % _lua_type(a))
            if not isinstance(b, (bytes, int, float)) or isinstance(b, bool):
                raise LuaError(b"attempt to concatenate a %s value" % _lua_type(b))
            return _tostr(a) + _tostr(b)
        if op == "==":
            return self._eq(a, b)
        if op == "~=":
            return not self._eq(a, b)
        if op in ("<", "<=", ">", ">="):
            if isinstance(a, (int, float)) and not isinstance(a, bool) and isinstance(
                b, (int, float)
            ) and not isinstance(b, bool):
                pass
            elif isinstance(a, bytes) and isinstance(b, bytes):
                pass
            else:
                raise LuaError(
                    b"attempt to compare %s with %s" % (_lua_type(a), _lua_type(b))
                )
            if op == "<":
                return a < b
            if op == "<=":
                return a <= b
            if op == ">":
                return a > b
            return a >= b
        x = _arith_operand(a, op)
        y = _arith_operand(b, op)
        if op == "+":
            return x + y
        if op == "-":
            return x - y
        if op == "*":
            return x * y
        if op == "/":
            if y == 0:
                return math.inf if x > 0 else (-math.inf if x < 0 else math.nan)
            return x / y
        if op == "%":
            if y == 0:
                return math.nan
            return x - math.floor(x / y) * y
        if op == "^":
            return x ** y
        raise LuaError(b"unknown operator")  # pragma: no cover

    @staticmethod
    def _eq(a, b) -> bool:
        if isinstance(a, bool) or isinstance(b, bool) or a is None or b is None:
            return a is b if (a is None or b is None) else a == b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return float(a) == float(b)
        if isinstance(a, bytes) and isinstance(b, bytes):
            return a == b
        return a is b


# ---------------------------------------------------------------------------
# Stdlib + redis bridge
# ---------------------------------------------------------------------------


def _stdlib(redis_call: Callable[[List[bytes]], Any]) -> _Env:
    g = _Env()

    def lua_redis_call(*args):
        call_args = []
        for a in args:
            if isinstance(a, bytes):
                call_args.append(a)
            elif isinstance(a, (int, float)) and not isinstance(a, bool):
                call_args.append(_numfmt(float(a)))
            else:
                raise LuaError(
                    b"Lua redis() command arguments must be strings or integers"
                )
        return resp_to_lua_value(redis_call(call_args))

    def lua_redis_pcall(*args):
        try:
            return lua_redis_call(*args)
        except LuaError as e:
            t = LuaTable()
            t.set(b"err", _tostr(e.lua_message))
            return t

    redis_tbl = LuaTable()
    redis_tbl.set(b"call", lua_redis_call)
    redis_tbl.set(b"pcall", lua_redis_pcall)

    def status_reply(msg):
        t = LuaTable()
        t.set(b"ok", _tostr(msg))
        return t

    def error_reply(msg):
        t = LuaTable()
        t.set(b"err", _tostr(msg))
        return t

    redis_tbl.set(b"status_reply", status_reply)
    redis_tbl.set(b"error_reply", error_reply)
    g.declare("redis", redis_tbl)

    g.declare("tonumber", lambda v=None, base=None: _tonumber(v, base))
    g.declare("tostring", lambda v=None: _tostr(v))
    g.declare("type", lambda v=None: _lua_type(v))

    def lua_error(msg=None, _level=None):
        raise LuaError(msg if msg is not None else b"error")

    def lua_assert(v=None, msg=None):
        if not _truthy(v):
            raise LuaError(msg if msg is not None else b"assertion failed!")
        return v

    g.declare("error", lua_error)
    g.declare("assert", lua_assert)

    def lua_pairs(t):
        if not isinstance(t, LuaTable):
            raise LuaError(b"bad argument to 'pairs' (table expected)")
        return list(t.hash.items())

    def lua_ipairs(t):
        if not isinstance(t, LuaTable):
            raise LuaError(b"bad argument to 'ipairs' (table expected)")
        return [(float(i), v) for i, v in enumerate(t.array(), start=1)]

    g.declare("pairs", lua_pairs)
    g.declare("ipairs", lua_ipairs)

    def lua_unpack(t, i=1.0, j=None):
        # Our calls are single-valued; unpack returns the FIRST element to
        # stay type-safe. Scripts in the repo use unpack only as full
        # varargs to redis.call — handled specially at call sites? No:
        # keep honest and reject multi-element unpack instead of silently
        # mis-running.
        if not isinstance(t, LuaTable):
            raise LuaError(b"bad argument to 'unpack' (table expected)")
        n = t.length() if j is None else int(j)
        if n - int(i) + 1 > 1:
            raise LuaError(
                b"unpack with more than one value is not supported by this "
                b"interpreter; pass arguments explicitly"
            )
        return t.get(float(i))

    g.declare("unpack", lua_unpack)

    table_tbl = LuaTable()

    def table_insert(t, a, b=None):
        if not isinstance(t, LuaTable):
            raise LuaError(b"bad argument to 'insert' (table expected)")
        if b is None:
            t.set(float(t.length() + 1), a)
        else:
            pos = int(_arith_operand(a, "insert"))
            arr = t.array()
            arr.insert(pos - 1, b)
            for i, v in enumerate(arr, start=1):
                t.set(float(i), v)
        return None

    def table_remove(t, pos=None):
        if not isinstance(t, LuaTable):
            raise LuaError(b"bad argument to 'remove' (table expected)")
        n = t.length()
        if n == 0:
            return None
        idx = n if pos is None else int(pos)
        arr = t.array()
        if idx < 1 or idx > n:
            return None
        v = arr.pop(idx - 1)
        for i in range(1, n + 1):
            t.set(float(i), arr[i - 1] if i <= len(arr) else None)
        return v

    table_tbl.set(b"insert", table_insert)
    table_tbl.set(b"remove", table_remove)
    table_tbl.set(b"getn", lambda t: float(t.length()))
    g.declare("table", table_tbl)

    string_tbl = LuaTable()

    def _str_arg(s):
        if isinstance(s, (int, float)) and not isinstance(s, bool):
            return _numfmt(float(s))
        if not isinstance(s, bytes):
            raise LuaError(b"bad argument (string expected)")
        return s

    def str_sub(s, i, j=None):
        s = _str_arg(s)
        n = len(s)
        i = int(i)
        j = -1 if j is None else int(j)
        if i < 0:
            i = max(n + i + 1, 1)
        elif i == 0:
            i = 1
        if j < 0:
            j = n + j + 1
        elif j > n:
            j = n
        if i > j:
            return b""
        return s[i - 1 : j]

    def str_format(fmt, *args):
        fmt = _str_arg(fmt)
        out = bytearray()
        ai = 0
        i = 0
        while i < len(fmt):
            c = fmt[i : i + 1]
            if c == b"%" and i + 1 < len(fmt):
                spec = fmt[i + 1 : i + 2]
                if spec == b"%":
                    out += b"%"
                elif spec in b"sdif":
                    v = args[ai] if ai < len(args) else None
                    ai += 1
                    if spec == b"s":
                        out += _tostr(v)
                    elif spec in b"di":
                        out += b"%d" % int(_arith_operand(v, "format"))
                    else:
                        out += b"%f" % _arith_operand(v, "format")
                else:
                    raise LuaError(b"unsupported format spec %%%s" % spec)
                i += 2
                continue
            out += c
            i += 1
        return bytes(out)

    string_tbl.set(b"sub", str_sub)
    string_tbl.set(b"len", lambda s: float(len(_str_arg(s))))
    string_tbl.set(b"rep", lambda s, n: _str_arg(s) * int(n))
    string_tbl.set(b"lower", lambda s: _str_arg(s).lower())
    string_tbl.set(b"upper", lambda s: _str_arg(s).upper())
    string_tbl.set(b"format", str_format)
    g.declare("string", string_tbl)

    math_tbl = LuaTable()
    math_tbl.set(b"floor", lambda x: float(math.floor(_arith_operand(x, "floor"))))
    math_tbl.set(b"ceil", lambda x: float(math.ceil(_arith_operand(x, "ceil"))))
    math_tbl.set(b"max", lambda *xs: float(max(_arith_operand(x, "max") for x in xs)))
    math_tbl.set(b"min", lambda *xs: float(min(_arith_operand(x, "min") for x in xs)))
    math_tbl.set(b"huge", None)  # set below as a plain value
    math_tbl.hash[b"huge"] = math.inf
    math_tbl.set(b"abs", lambda x: float(abs(_arith_operand(x, "abs"))))
    g.declare("math", math_tbl)
    return g


def resp_to_lua_value(v):
    """RESP reply -> Lua value per the server's EVAL conversion rules."""
    if v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return float(v)
    if isinstance(v, float):
        return _numfmt(v)  # RESP has no doubles in v2; defensive
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, list):
        return LuaTable([resp_to_lua_value(x) for x in v])
    if isinstance(v, dict) and ("ok" in v or "err" in v):
        t = LuaTable()
        for k, val in v.items():
            t.set(k.encode() if isinstance(k, str) else k, _tostr(val))
        return t
    raise LuaError(b"cannot convert reply to Lua value")


def lua_to_resp_value(v):
    """Lua return value -> structured RESP value (int/bytes/None/list/dict)."""
    if v is None or v is False:
        return None
    if v is True:
        return 1
    if isinstance(v, (int, float)):
        return int(v)  # Lua->Redis truncates to integer
    if isinstance(v, bytes):
        return v
    if isinstance(v, LuaTable):
        ok = v.get(b"ok")
        if ok is not None:
            return {"ok": ok}
        err = v.get(b"err")
        if err is not None:
            return {"err": err}
        out = []
        i = 1
        while True:
            item = v.get(float(i))
            if item is None or item is False:
                if item is False:
                    out.append(None)
                    i += 1
                    continue
                break
            out.append(lua_to_resp_value(item))
            i += 1
        return out
    raise LuaError(b"unsupported return type")


_SCRIPT_CACHE: Dict[bytes, list] = {}


def run_script(
    source: bytes,
    keys: List[bytes],
    argv: List[bytes],
    redis_call: Callable[[List[bytes]], Any],
):
    """Parse (with cache) and execute a script; returns the structured RESP
    value (as lua_to_resp_value)."""
    if isinstance(source, str):
        source = source.encode()
    ast = _SCRIPT_CACHE.get(source)
    if ast is None:
        ast = _Parser(_tokenize(source)).parse_chunk()
        if len(_SCRIPT_CACHE) > 1024:
            _SCRIPT_CACHE.clear()
        _SCRIPT_CACHE[source] = ast
    g = _stdlib(redis_call)
    g.declare("KEYS", LuaTable(list(keys)))
    g.declare("ARGV", LuaTable(list(argv)))
    interp = _Interp(g)
    env = _Env(g)
    try:
        interp.exec_chunk(ast, env)
    except _Return as r:
        return lua_to_resp_value(r.value)
    return None
