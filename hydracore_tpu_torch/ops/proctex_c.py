"""Procedural-texture C source -> torch callables: the JAX package's
ops/proctex_c.py.

The reference splices user shader source from the scene XML into its
texture kernel and recompiles at run time (RenderDriverRTE_ProcTex.cpp:
467-563; the stdlib the shaders see is texproc.cl:1-93: floatN ops,
texture2D, readAttr_* accessors). Here the same C subset is parsed once
into a tuple AST, and every call evaluates that AST eagerly over the ray
batch, returning a callable of the ops/proctex.py registry protocol:

    fn(uv (R,2), pos (R,3), normal (R,3), wo (R,3), args (R,A), sample2d,
       ao (R,)) -> (R,4)

Supported subset (everything the bundled and production shaders use):
  * helper function definitions and the prtexN_main entry
  * types: float, int, bool, float2/3/4, sampler2D (float-coded slot id)
  * expressions: arithmetic, comparisons, &&/||/!, ?:, member access
    .x/.y/.z/.w and 2-4 lane swizzles, calls, literals (f suffix ok)
  * statements: declarations (const ok), (compound) assignment incl.
    member lvalues, if/else (predicated: both sides evaluate, results
    merge by mask), early return (predicated), for loops with literal
    bounds (unrolled, cap 64)
  * builtins: make_floatN, dot, cross, normalize, length, fabs, min, max,
    clamp, mix/lerp, pow, sqrt, rsqrt, exp, log, sin, cos, tan, floor,
    ceil, fmod, fract, sign, step, smoothstep, atan2, to_float3,
    texture2D(slot, uv, flags) and the readAttr_* SurfaceInfo accessors
    (readAttr_LocalPos reads the world position, hr_viewVectorHack wo)

The JAX package's semantics are kept, not C's: every value is a float32
(ints too), `%` is fmod, sqrt and log clamp their argument, pow clamps its
base at 0, normalize has a floor of 1e-20 on the squared length. A shader
whose main (or helper) returns on no path compiles, and raises when it is
evaluated. Values are never written in place: a splatted value is a view
of one lane, so a member assignment builds a new tensor. Anything outside
the subset raises ProcTexCompileError; ops/proctex.register_stdlib_instance
then falls back to the name-matched stdlib.
"""
from __future__ import annotations

import math
import re

import torch

from hydracore_tpu_torch.utils.math3d import make_orthonormal_basis, sqrt

__all__ = ["ProcTexCompileError", "compile_proc_tex"]


class ProcTexCompileError(ValueError):
    pass


# ----------------------------------------------------------------------------
# Lexer
# ----------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<num>   (?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?[fF]?)
  | (?P<id>    [A-Za-z_]\w*)
  | (?P<op>    \+=|-=|\*=|/=|\|\||&&|==|!=|<=|>=|->|[-+*/%<>=!?:;,.(){}\[\]&])
  | (?P<ws>    \s+)
""", re.VERBOSE)

_TYPES = {"float", "int", "bool", "unsigned", "float2", "float3", "float4",
          "sampler2D", "void"}
_QUALS = {"const", "static", "inline", "__global", "restrict", "__constant"}


def _lex(src: str):
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    src = re.sub(r"//[^\n]*", " ", src)
    toks = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise ProcTexCompileError(f"lex error at {src[i:i+24]!r}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append((m.lastgroup, m.group()))
    toks.append(("eof", ""))
    return toks


# ----------------------------------------------------------------------------
# Values: tensors tagged with a C-ish width (1 = scalar, 2/3/4 = floatN)
# ----------------------------------------------------------------------------

class V:
    __slots__ = ("a", "w")

    def __init__(self, a, w):
        self.a = a  # () / (w,) constant or (R,) / (R, w) batched; f32 or bool
        self.w = int(w)


def _splat(v: V, w: int) -> V:
    if v.w == w:
        return v
    if v.w == 1:
        return V(v.a[..., None].expand(*v.a.shape, w), w)
    raise ProcTexCompileError(f"width mismatch {v.w} vs {w}")


def _f(v: V) -> V:  # bool -> float
    if v.a.dtype == torch.bool:
        return V(v.a.to(torch.float32), v.w)
    return v


def _binop(op, x: V, y: V) -> V:
    x, y = _f(x), _f(y)
    w = max(x.w, y.w)
    return V(op(_splat(x, w).a, _splat(y, w).a), w)


_COMP = {"x": 0, "y": 1, "z": 2, "w": 3}


# ----------------------------------------------------------------------------
# Parser -> nested-tuple AST
# ----------------------------------------------------------------------------

class _P:
    def __init__(self, toks):
        self.t = toks
        self.i = 0

    def peek(self, k=0):
        return self.t[min(self.i + k, len(self.t) - 1)]

    def next(self):
        tok = self.t[self.i]
        self.i += 1
        return tok

    def expect(self, val):
        _, v = self.next()
        if v != val:
            raise ProcTexCompileError(f"expected {val!r}, got {v!r}")

    def accept(self, val):
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # ---- declarations
    def parse_program(self):
        funcs = {}
        while self.peek()[0] != "eof":
            f = self.parse_func()
            funcs[f[0]] = f
        return funcs

    def _skip_quals(self):
        while self.peek()[1] in _QUALS:
            self.next()

    def parse_func(self):
        self._skip_quals()
        _, rtype = self.next()
        if rtype not in _TYPES:
            raise ProcTexCompileError(f"expected type, got {rtype!r}")
        k, name = self.next()
        if k != "id":
            raise ProcTexCompileError(f"expected function name, got {name!r}")
        self.expect("(")
        params = []
        while not self.accept(")"):
            self._skip_quals()
            _, ptype = self.next()
            if ptype == "_PROCTEXTAILTAG_":  # the reference's tail-args macro
                self.accept(",")
                continue
            if ptype not in _TYPES and ptype != "SurfaceInfo":
                raise ProcTexCompileError(f"bad param type {ptype!r}")
            while self.peek()[1] == "*":
                self.next()
            _, pname = self.next()
            params.append((ptype, pname))
            self.accept(",")
        return (name, rtype, params, self.parse_block())

    def parse_block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.parse_stmt())
        return ("block", stmts)

    def parse_stmt(self):
        k, v = self.peek()
        if v == "{":
            return self.parse_block()
        if v == "return":
            self.next()
            e = self.parse_expr()
            self.expect(";")
            return ("return", e)
        if v == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            els = self.parse_stmt() if self.accept("else") else None
            return ("if", cond, then, els)
        if v == "for":
            return self.parse_for()
        if v in _QUALS or v in _TYPES:
            self._skip_quals()
            _, ty = self.next()
            if ty not in _TYPES:
                raise ProcTexCompileError(f"bad decl type {ty!r}")
            decls = []
            while True:
                _, name = self.next()
                init = self.parse_expr() if self.accept("=") else None
                decls.append((name, init))
                if not self.accept(","):
                    break
            self.expect(";")
            return ("decl", ty, decls)
        # assignment or bare expression
        start = self.i
        if k == "id":
            name = self.next()[1]
            comp = None
            if self.accept("."):
                comp = self.next()[1]
            op = self.peek()[1]
            if op in ("=", "+=", "-=", "*=", "/="):
                self.next()
                e = self.parse_expr()
                self.expect(";")
                return ("assign", name, comp, op, e)
        self.i = start
        e = self.parse_expr()
        self.expect(";")
        return ("expr", e)

    def parse_for(self):
        self.expect("for")
        self.expect("(")
        self._skip_quals()
        _, ty = self.next()
        if ty not in ("int", "unsigned"):
            raise ProcTexCompileError("for: only int counters")
        _, var = self.next()
        self.expect("=")
        k, lo = self.next()
        if k != "num":
            raise ProcTexCompileError("for: literal start required")
        self.expect(";")
        _, var2 = self.next()
        if var2 != var:
            raise ProcTexCompileError("for: malformed condition")
        cmp_op = self.next()[1]
        k, hi = self.next()
        if k != "num" or cmp_op not in ("<", "<="):
            raise ProcTexCompileError("for: literal bound required")
        self.expect(";")
        while self.peek()[1] != ")":  # i++ / ++i / i += 1
            self.next()
        self.expect(")")
        body = self.parse_stmt()
        lo_i, hi_i = int(float(lo.rstrip("fF"))), int(float(hi.rstrip("fF")))
        if cmp_op == "<=":
            hi_i += 1
        if hi_i - lo_i > 64:
            raise ProcTexCompileError("for: trip count > 64")
        return ("for", var, lo_i, hi_i, body)

    # ---- expressions (precedence climbing)
    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        c = self.parse_or()
        if self.accept("?"):
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_ternary()
            return ("?:", c, a, b)
        return c

    def _bin_level(self, ops, sub):
        e = sub()
        while self.peek()[1] in ops:
            op = self.next()[1]
            e = ("bin", op, e, sub())
        return e

    def parse_or(self):
        return self._bin_level(("||",), self.parse_and)

    def parse_and(self):
        return self._bin_level(("&&",), self.parse_cmp)

    def parse_cmp(self):
        return self._bin_level(("<", ">", "<=", ">=", "==", "!="),
                               self.parse_add)

    def parse_add(self):
        return self._bin_level(("+", "-"), self.parse_mul)

    def parse_mul(self):
        return self._bin_level(("*", "/", "%"), self.parse_unary)

    def parse_unary(self):
        v = self.peek()[1]
        if v in ("-", "!", "+"):
            self.next()
            return ("un", v, self.parse_unary())
        if v == "(" and self.peek(1)[1] in _TYPES and self.peek(2)[1] == ")":
            self.next(), self.next(), self.next()  # a C cast: no-op
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            if self.accept(".") or self.accept("->"):
                e = ("member", e, self.next()[1])
            else:
                return e

    def parse_primary(self):
        k, v = self.next()
        if k == "num":
            return ("num", float(v.rstrip("fF")))
        if v == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if k == "id":
            if self.accept("("):
                args = []
                while not self.accept(")"):
                    args.append(self.parse_expr())
                    self.accept(",")
                return ("call", v, args)
            return ("var", v)
        raise ProcTexCompileError(f"unexpected token {v!r}")


# ----------------------------------------------------------------------------
# Evaluator
# ----------------------------------------------------------------------------

def _sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x))  # NaN stays NaN


def _mk_builtins():
    def vec(args, w):
        comps = []
        for a in args:
            a = _f(a)
            comps.append(a.a[..., None] if a.w == 1 else a.a)
        # batched and constant components broadcast to one batch shape
        batch = torch.broadcast_shapes(*[c.shape[:-1] for c in comps])
        comps = [c.expand(*batch, c.shape[-1]) for c in comps]
        if len(comps) == 1 and comps[0].shape[-1] == 1:
            cat = comps[0].expand(*batch, w)
        else:
            cat = torch.cat(comps, dim=-1)
        if cat.shape[-1] != w:
            raise ProcTexCompileError(f"make_float{w}: got {cat.shape[-1]}")
        return V(cat, w)

    def b1(fn):  # elementwise, any width
        return lambda args, ctx: V(fn(_f(args[0]).a), args[0].w)

    def b2(fn):
        return lambda args, ctx: _binop(fn, args[0], args[1])

    def _dot(args, ctx):
        x, y = _f(args[0]), _f(args[1])
        w = max(x.w, y.w)
        return V((_splat(x, w).a * _splat(y, w).a).sum(dim=-1), 1)

    def _length(args, ctx):
        x = _f(args[0])
        return V(sqrt(torch.clamp((x.a * x.a).sum(dim=-1), min=0.0)), 1)

    def _normalize(args, ctx):
        x = _f(args[0])
        n = sqrt(torch.clamp((x.a * x.a).sum(dim=-1, keepdim=True),
                             min=1e-20))
        return V(x.a / n, x.w)

    def _cross(args, ctx):
        a, b = _splat(_f(args[0]), 3).a, _splat(_f(args[1]), 3).a
        return V(torch.stack([
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1), 3)

    def _clamp(args, ctx=None):
        return _binop(torch.minimum, _binop(torch.maximum, args[0], args[1]),
                      args[2])

    def _mix(args, ctx):
        x, y, a = args
        one = ctx.const(1.0)
        return _binop(torch.add, _binop(torch.mul, x,
                                        _binop(torch.sub, one, a)),
                      _binop(torch.mul, y, a))

    def _smoothstep(args, ctx):
        e0, e1, x = args
        t = _clamp([_binop(torch.div, _binop(torch.sub, x, e0),
                           _binop(torch.sub, e1, e0)),
                    ctx.const(0.0), ctx.const(1.0)])
        ta = _f(t).a
        return V(ta * ta * (3.0 - 2.0 * ta), t.w)

    def _step(args, ctx):
        return _binop(lambda e, x: (x >= e).to(torch.float32),
                      args[0], args[1])

    def _fract(args, ctx):
        x = _f(args[0])
        return V(x.a - torch.floor(x.a), x.w)

    def _to3(args, ctx):
        x = _f(args[0])
        if x.w >= 3:
            return V(x.a[..., :3], 3)
        return _splat(x, 3)

    return {
        "make_float2": lambda a, ctx: vec(a, 2),
        "make_float3": lambda a, ctx: vec(a, 3),
        "make_float4": lambda a, ctx: vec(a, 4),
        "to_float3": _to3, "to_float4": lambda a, ctx: vec(a, 4),
        "dot": _dot, "cross": _cross, "normalize": _normalize,
        "length": _length, "fast_length": _length,
        "fabs": b1(torch.abs), "abs": b1(torch.abs),
        "sqrt": b1(lambda x: sqrt(torch.clamp(x, min=0.0))),
        "rsqrt": b1(lambda x: 1.0 / sqrt(torch.clamp(x, min=1e-20))),
        "exp": b1(torch.exp),
        "log": b1(lambda x: torch.log(torch.clamp(x, min=1e-30))),
        "sin": b1(torch.sin), "cos": b1(torch.cos), "tan": b1(torch.tan),
        "asin": b1(lambda x: torch.asin(torch.clamp(x, -1, 1))),
        "acos": b1(lambda x: torch.acos(torch.clamp(x, -1, 1))),
        "atan": b1(torch.atan),
        "floor": b1(torch.floor), "ceil": b1(torch.ceil),
        "sign": b1(_sign),
        "pow": b2(lambda x, y: torch.pow(torch.clamp(x, min=0.0), y)),
        "fmod": b2(torch.fmod), "atan2": b2(torch.atan2),
        "min": b2(torch.minimum), "fmin": b2(torch.minimum),
        "max": b2(torch.maximum), "fmax": b2(torch.maximum),
        "clamp": _clamp, "mix": _mix, "lerp": _mix,
        "smoothstep": _smoothstep, "step": _step, "fract": _fract,
    }


_BUILTINS = _mk_builtins()

_ATTR_MAP = {  # readAttr_*(sHit) -> context key (texproc.cl:50-57)
    "readAttr_WorldPos": "pos", "readAttr_LocalPos": "pos",
    "readAttr_ShadeNorm": "normal", "readAttr_TexCoord0": "uv",
    "readAttr_Tangent": "tang", "readAttr_Bitangent": "bitang",
    "readAttr_AO": "ao", "readAttr_AO1": "ao",
}

_BIN = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
        "%": torch.fmod, "<": torch.lt, ">": torch.gt, "<=": torch.le,
        ">=": torch.ge, "==": torch.eq, "!=": torch.ne,
        "&&": torch.logical_and, "||": torch.logical_or}
_COMPOUND = {"+=": torch.add, "-=": torch.sub, "*=": torch.mul,
             "/=": torch.div}


class _Ctx:
    """What the evaluation reads besides the environment: the functions,
    the surface attributes, the texture sampler, the device and the
    compiled shader's constants (0-d f32 tensors by (device, value), made
    once, never written)."""

    def __init__(self, funcs, surf, sample2d, device, consts: dict):
        self.funcs = funcs
        self.surf = surf
        self.sample2d = sample2d
        self.device = device
        self.consts = consts
        self.depth = 0

    def const(self, value: float) -> V:
        key = (str(self.device), float(value))
        c = self.consts.get(key)
        if c is None:
            c = self.consts[key] = torch.full((), float(value),
                                              dtype=torch.float32,
                                              device=self.device)
        return V(c, 1)

    def true(self) -> V:
        return V(torch.ones((), dtype=torch.bool, device=self.device), 1)


def _eval_expr(e, env, ctx: _Ctx) -> V:
    tag = e[0]
    if tag == "num":
        return ctx.const(e[1])
    if tag == "var":
        name = e[1]
        if name in env:
            return env[name]
        if name == "hr_viewVectorHack":
            return V(ctx.surf["wo"], 3)
        if name in ("M_PI", "M_PI_F", "PI"):
            return ctx.const(math.pi)
        if name == "sHit":
            return ctx.const(0.0)  # an opaque handle
        raise ProcTexCompileError(f"unknown identifier {name!r}")
    if tag == "un":
        v = _eval_expr(e[2], env, ctx)
        if e[1] == "-":
            return V(-_f(v).a, v.w)
        if e[1] == "+":
            return v
        return V(~v.a if v.a.dtype == torch.bool else v.a == 0.0, v.w)
    if tag == "bin":
        op = e[1]
        x = _eval_expr(e[2], env, ctx)
        y = _eval_expr(e[3], env, ctx)
        if op in ("&&", "||"):
            return V(_BIN[op](x.a.to(torch.bool), y.a.to(torch.bool)),
                     max(x.w, y.w))
        if op in ("<", ">", "<=", ">=", "==", "!="):
            x, y = _f(x), _f(y)
            w = max(x.w, y.w)
            return V(_BIN[op](_splat(x, w).a, _splat(y, w).a), w)
        return _binop(_BIN[op], x, y)
    if tag == "?:":
        c = _eval_expr(e[1], env, ctx)
        a = _f(_eval_expr(e[2], env, ctx))
        b = _f(_eval_expr(e[3], env, ctx))
        w = max(a.w, b.w)
        ca = c.a.to(torch.bool)
        if w > 1 and c.w == 1:
            ca = ca[..., None]
        return V(torch.where(ca, _splat(a, w).a, _splat(b, w).a), w)
    if tag == "member":
        base = _eval_expr(e[1], env, ctx)
        name = e[2]
        if all(ch in _COMP for ch in name):  # swizzle
            idxs = [_COMP[ch] for ch in name]
            if base.w == 1:
                raise ProcTexCompileError("member access on scalar")
            if len(idxs) == 1:
                return V(base.a[..., idxs[0]], 1)
            return V(base.a[..., idxs], len(idxs))
        raise ProcTexCompileError(f"unsupported member .{name}")
    if tag == "call":
        name, args_ast = e[1], e[2]
        if name in _ATTR_MAP:
            val = ctx.surf[_ATTR_MAP[name]]
            return V(val, 1 if val.dim() == 1 else val.shape[-1])
        if name == "texture2D":
            args = [_eval_expr(a, env, ctx) for a in args_ast[:2]]
            slot = _f(args[0]).a
            uv = _splat(_f(args[1]), 2).a
            return V(ctx.sample2d(slot, uv), 4)
        args = [_eval_expr(a, env, ctx) for a in args_ast]
        if name in _BUILTINS:
            return _BUILTINS[name](args, ctx)
        if name in ctx.funcs:
            return _call_user(ctx.funcs[name], args, ctx)
        raise ProcTexCompileError(f"unknown function {name!r}")
    raise ProcTexCompileError(f"bad expr node {tag!r}")


_PTYPE_W = {"float": 1, "int": 1, "bool": 1, "unsigned": 1, "sampler2D": 1,
            "float2": 2, "float3": 3, "float4": 4}


def _call_user(fdef, args, ctx: _Ctx):
    name, _, params, body = fdef
    if ctx.depth > 8:
        raise ProcTexCompileError("call depth > 8 (recursion?)")
    env = {}
    ai = 0
    for ptype, pname in params:
        if ptype == "SurfaceInfo":
            continue
        if ai >= len(args):
            raise ProcTexCompileError(f"{name}: missing arg {pname}")
        env[pname] = args[ai]
        ai += 1
    ctx.depth += 1
    try:
        ret = _exec_block(body, env, ctx, active=ctx.true(), ret=None)
    finally:
        ctx.depth -= 1
    if ret is None:
        raise ProcTexCompileError(f"{name}: no return")
    return ret[0]


def _merge(old: V | None, new: V, mask: V) -> V:
    """where(mask, new, old) with width and batch-shape promotion (values
    may be constants () / (w,) or batched (R,) / (R, w)). torch.where, not
    a product with the mask, so a NaN or inf on the side not taken never
    reaches the result."""
    if old is None:
        old = new
    new, old = _f(new), _f(old)
    w = max(new.w, old.w)
    na, oa = torch.broadcast_tensors(_splat(new, w).a, _splat(old, w).a)
    ma = mask.a.to(torch.bool)
    if w > 1 and ma.dim() < na.dim():
        ma = ma[..., None]
    return V(torch.where(ma, na, oa), w)


def _exec_block(node, env, ctx, active: V, ret):
    """Execute statements under the lane mask `active`. `ret` is
    (value, taken mask) or None; returns the updated ret."""
    kind = node[0]
    if kind == "block":
        for s in node[1]:
            ret = _exec_block(s, env, ctx, active, ret)
        return ret
    # lanes that already returned stop updating state
    live = active if ret is None else \
        V(active.a.to(torch.bool) & ~ret[1].a.to(torch.bool), 1)
    if kind == "decl":
        for name, init in node[2]:
            env[name] = (_eval_expr(init, env, ctx) if init is not None
                         else ctx.const(0.0))
        return ret
    if kind == "assign":
        name, comp, op, expr = node[1], node[2], node[3], node[4]
        val = _eval_expr(expr, env, ctx)
        if name not in env:
            raise ProcTexCompileError(f"assign to undeclared {name!r}")
        cur = env[name]
        if comp is not None:
            idx = _COMP.get(comp)
            if idx is None or cur.w == 1 or idx >= cur.w:
                raise ProcTexCompileError(f"bad member assign .{comp}")
            old_c = V(cur.a[..., idx], 1)
            if op != "=":
                val = _binop(_COMPOUND[op], old_c, val)
            new_c = _merge(old_c, _splat(_f(val), 1), live)
            base = cur.a
            if base.dim() == 1:  # a constant vector
                base = base[None].expand(1, cur.w)
            # a new tensor: `base` may be a view shared with other values
            out = base.clone()
            out[..., idx] = new_c.a.expand(base[..., idx].shape)
            env[name] = V(out, cur.w)
        else:
            if op != "=":
                val = _binop(_COMPOUND[op], cur, val)
            env[name] = _merge(cur, val, live)
        return ret
    if kind == "return":
        val = _f(_eval_expr(node[1], env, ctx))
        if ret is None:
            prev = None
            taken = V(torch.zeros((), dtype=torch.bool, device=ctx.device), 1)
        else:
            prev, taken = ret
        new_val = _merge(prev, val, live) if prev is not None else val
        # lanes returning now are the live ones; earlier ones keep theirs
        if prev is not None:
            new_val = _merge(new_val, prev, taken)
        return (new_val, V(taken.a.to(torch.bool) | live.a.to(torch.bool), 1))
    if kind == "if":
        cmask = _eval_expr(node[1], env, ctx).a.to(torch.bool)
        then_active = V(live.a.to(torch.bool) & cmask, 1)
        else_active = V(live.a.to(torch.bool) & ~cmask, 1)
        base_env = dict(env)
        ret = _exec_block(node[2], env, ctx, then_active, ret)
        if node[3] is not None:
            # the else branch starts from the state before the then branch
            # for its lanes: run it on a copy, merge by the else mask
            env2 = dict(base_env)
            ret = _exec_block(node[3], env2, ctx, else_active, ret)
            for kk in set(env) | set(env2):
                if kk in env and kk in env2 and env[kk] is not env2[kk]:
                    env[kk] = _merge(env[kk], env2[kk], else_active)
                elif kk not in env:
                    env[kk] = env2[kk]
        return ret
    if kind == "for":
        var, lo, hi, body = node[1], node[2], node[3], node[4]
        for it in range(lo, hi):
            env[var] = ctx.const(float(it))
            ret = _exec_block(body, env, ctx, live, ret)
        return ret
    if kind == "expr":
        _eval_expr(node[1], env, ctx)
        return ret
    raise ProcTexCompileError(f"bad stmt {kind!r}")


# ----------------------------------------------------------------------------
# Entry: compile source + XML arg layout -> registry callable
# ----------------------------------------------------------------------------

def compile_proc_tex(source: str, main: str | None = None,
                     gen_args: list | None = None):
    """Compile procedural-texture C source to a registry-protocol callable.

    gen_args: the statefile <generated><arg> layout, [(name, type,
    woffset, wsize), ...], mapping named parameters onto the material's
    8-float arg stack (ReadAllProcTexArgsFromMaterialNode,
    RenderDriverRTE_ProcTex.cpp:116-190). Without it float and sampler
    parameters take stack slots in declaration order."""
    funcs = _P(_lex(source)).parse_program()
    if not funcs:
        raise ProcTexCompileError("no functions found")
    entry = None
    if main and main in funcs:
        entry = funcs[main]
    else:
        for name, f in funcs.items():
            if name.endswith("_main") or name == "main":
                entry = f
        if entry is None:
            raise ProcTexCompileError("no *_main entry found")

    _, _, params, body = entry
    shader_params = [(t, n) for (t, n) in params if t != "SurfaceInfo"]

    layout = []
    if gen_args:
        for (name, _, woff, wsize) in gen_args:
            layout.append((name, int(woff), int(wsize)))
    else:
        off = 0
        for ptype, pname in shader_params:
            w = _PTYPE_W.get(ptype, 1)
            layout.append((pname, off, w))
            off += w
    byname = {n: (o, w) for (n, o, w) in layout}
    consts: dict = {}  # the literals of this shader, per device

    def fn(uv, pos, normal, wo, args, sample2d, ao=None):
        R = uv.shape[0]
        dev = uv.device
        if ao is None:
            ao = torch.ones((R,), dtype=torch.float32, device=dev)
        # tangent frame for readAttr_Tangent / readAttr_Bitangent
        tang, bitang = make_orthonormal_basis(normal)
        ctx = _Ctx(funcs, {"uv": uv, "pos": pos, "normal": normal, "wo": wo,
                           "ao": ao, "tang": tang, "bitang": bitang},
                   sample2d, dev, consts)
        env = {}
        for _, pname in shader_params:
            if pname not in byname:
                raise ProcTexCompileError(f"arg {pname!r} not in layout")
            off, w = byname[pname]
            env[pname] = V(args[:, off] if w == 1 else args[:, off:off + w], w)
        ret = _exec_block(body, env, ctx, ctx.true(), None)
        if ret is None:
            raise ProcTexCompileError("main: no return")
        out = _f(ret[0])
        if out.w == 1:
            out = _splat(out, 3)
        a = out.a
        if a.dim() == 1:
            a = a[None, :].expand(R, a.shape[0])
        if a.shape[-1] == 3:
            a = torch.cat([a, torch.ones(a.shape[:-1] + (1,),
                                         dtype=torch.float32, device=dev)], -1)
        return a[..., :4]

    fn.__name__ = f"proctex_{entry[0]}"
    return fn
