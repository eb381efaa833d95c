"""The Hopper forms of the doubling and the three adders (csrc/g1_fused.cu,
g1s_body), of fq_apply and of fq_mul (csrc/g1_affine.cu) and of fq_mul_canon
(csrc/proto_mul.cu) on the CPU, through four host models.

The product. `_mul_ptx_host` runs the inline PTX of csrc/fq_mul_ptx.cuh as
the header spells it: the asm statements are read from the source and every
instruction is executed on 32-bit words with the carry flag, which starts
undefined in each statement (so a chain that took its carry from another
statement would fail). An instruction that writes no carry must not
overflow. The result is held against the integer (a b + m p) / 2^384.

The schedule. `_schedule_host` runs a lane as the kernel does with R roles,
in each of g1s_body's four modes (g1_add, g1_add_sel, g1_add_sel_proj,
g1_double): the level-1 products (operand tables read from the source), the
derive jobs, the level-2 products (tables read from the source), the final
sums (the doubling's table read from the source), each step's values
exchanged through a dict that stands for shared memory, each role taking
items r, r + R, ... Masked lanes copy the accumulator. It is held against
the port's plain `_add_plain` / `_add_sel_plain` / `_add_sel_proj_plain` /
`_double_plain` and against the JAX package's `add_lf` / `add_sel_lf` /
`add_sel_proj_lf` / `double_lf` on seeded lanes with the planted kinds of
chip_smoke.py's `_g1_inputs` (the doubling: lazy values up to 2p and the
identity stored with z = 0 and z = p). Tolerance 0: field elements after
normalize, masked lanes bit for bit.

fq_apply. `_apply_host` executes the statements of `fq_apply_kernel` as
the source spells them (read from it): the loads, the products on
`_mul_ptx_host`, the sums, selects and flags. It is held against the
port's `_apply_plain` and the JAX package's `_apply_body` over all four
case codes, on canonical inputs and lazy representatives. Tolerance 0: the
stored limbs, before normalize.

fq_mul. `_fq_mul_lanes` maps the lanes of a launch to the threads as the
kernel and its launcher do (grid, stride and lanes a thread read from the
source); every lane must come out exactly once, at the lanes a thread the
source builds and at those that scripts/torch_g1_variants.py sweeps.

fq_mul_canon (csrc/proto_mul.cu). Its statements, read from the source, run
on `_mul_ptx_host` and one subtraction of q, against a*b*R^-1 mod q and the
plain version's limbs; its grid covers every lane once.
"""

import pathlib
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.curves import g1_affine as jga
from aleo_tpu.curves import g1_fused as jgf
from aleo_tpu_torch import _build
from aleo_tpu_torch.curves import g1_affine as tga
from aleo_tpu_torch.curves import g1_fused as tgf
from aleo_tpu_torch.fields import limbs

torch.set_num_threads(2)        # several test workers share the machine

Q = params.Q
L = params.FQ_LIMBS
R384 = 1 << 384
U32 = (1 << 32) - 1
NPRIME = (-pow(Q, -1, R384)) % R384
CSRC = pathlib.Path(_build.CSRC_DIR)


# -- the product: the header's PTX, instruction by instruction ---------------------


def _function(src: str, name: str) -> str:
    return re.search(r"void " + name + r"\((?:.*?)\) \{(.*?)\n\}", src, re.S).group(1)


def _asm_blocks(body: str):
    """asm statements of a function body -> [(instructions, operands)], an
    operand being (constraint, expression) in the statement's numbering."""
    out = []
    for stmt in re.findall(r"asm\((.*?)\);\n", body + "\n", re.S):
        text, _, rest = stmt.partition(":")
        code = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', text)).replace("\\n\\t", "")
        instrs = [i.strip() for i in code.split(";") if i.strip()]
        ops = re.findall(r'"(\+r|=r|r)"\(([^)]*)\)', rest)
        out.append((instrs, ops))
    return out


def _header():
    src = (CSRC / "fq_mul_ptx.cuh").read_text()
    consts = {k: int(v, 16) for k, v in re.findall(r"#define (FQX_P\d+) 0x([0-9a-f]+)u", src)}
    blocks = {fn: _asm_blocks(_function(src, fn)) for fn in ("fqx_row", "fqx_redc", "fq_mul_ptx")}
    return consts, blocks


CONSTS, BLOCKS = _header()


def _execute(block, env):
    """One asm statement on the host. env maps names to ints or lists of
    ints; the statement's operands are read first and its outputs written
    back last, as registers bound to them would be."""
    instrs, ops = block

    def read(expr):
        m = re.fullmatch(r"(\w+)\[(\d+)\]", expr)
        return env[m.group(1)][int(m.group(2))] if m else env[expr]

    regs = [None if c == "=r" else read(e) for c, e in ops]
    cf = None                               # undefined at the start of a statement

    def val(tok):
        return regs[int(tok[1:])] if tok.startswith("%") else int(tok, 0)

    for ins in instrs:
        op, args = ins.split(None, 1)
        args = [a.strip() for a in args.split(",")]
        parts = op.split(".")
        base, cc = parts[0], "cc" in parts
        carry_in = base in ("addc", "madc")
        if carry_in:
            assert cf is not None, f"{ins}: the carry comes from another statement"
        x, y = val(args[1]), val(args[2])
        assert x is not None and y is not None, f"{ins}: reads an undefined register"
        if base in ("add", "addc"):
            s = x + y
        else:
            prod = x * y
            s = (prod & U32 if "lo" in parts else prod >> 32) + val(args[3])
        s += cf if carry_in else 0
        if cc:
            cf = s >> 32
        else:
            assert s >> 32 == 0, f"{ins}: a carry would be lost"
        regs[int(args[0][1:])] = s & U32
    for (c, e), v in zip(ops, regs):
        if c != "r":
            m = re.fullmatch(r"(\w+)\[(\d+)\]", e)
            env[m.group(1)][int(m.group(2))] = v


def _words(x):
    return [(x >> (32 * i)) & U32 for i in range(12)]


def _row(e, o, a, bi):
    for block in BLOCKS["fqx_row"]:
        _execute(block, {"e": e, "o": o, "a": a, "bi": bi})


def _redc(e, o):
    env = {"e": e, "o": o, "mi": (-e[0]) & U32, **CONSTS}
    for block in BLOCKS["fqx_redc"]:
        _execute(block, env)


def _mul_ptx_host(x: int, y: int) -> int:
    """fq_mul_ptx on the host, statement for statement (fqx_row_first and
    the row loop are the header's C, spelled here)."""
    a, b = _words(x), _words(y)
    e = [0] * 12
    o = [0] * 12
    for j in range(0, 12, 2):                       # fqx_row_first
        e[j], e[j + 1] = (a[j] * b[0]) & U32, (a[j] * b[0]) >> 32
        o[j], o[j + 1] = (a[j + 1] * b[0]) & U32, (a[j + 1] * b[0]) >> 32
    _redc(e, o)
    for i in range(1, 12, 2):
        _row(o, e, a, b[i])
        _redc(o, e)
        if i + 1 < 12:
            _row(e, o, a, b[i + 1])
            _redc(e, o)
    (merge,) = BLOCKS["fq_mul_ptx"]
    _execute(merge, {"e": e, "o": o})
    return sum(w << (32 * i) for i, w in enumerate(e))


def _mont(x: int, y: int) -> int:
    """The one integer a Montgomery product without a final subtraction gives."""
    m = x * y * NPRIME % R384
    t = x * y + m * Q
    assert t % R384 == 0
    return t // R384


EDGE = [0, 1, Q - 1, Q, Q + 1, 2 * Q - 1, 2 * Q, (1 << 384) % Q]


def test_ptx_constants_are_the_words_of_p():
    words = _words(Q)
    assert words[0] == 1, "fq_mul_ptx takes p[0] = 1 for granted"
    assert (-pow(Q, -1, 1 << 32)) % (1 << 32) == U32, "and N' = 2^32 - 1"
    assert CONSTS == {f"FQX_P{i}": words[i] for i in range(1, 12)}


def test_ptx_statements_keep_their_carries_to_themselves():
    """Every chain starts with an instruction that reads no carry and ends
    with one that writes none: the compiler may put anything between two
    statements."""
    n = 0
    for blocks in BLOCKS.values():
        for instrs, ops in blocks:
            assert instrs[0].split()[0] in ("add.cc.u32", "mad.lo.cc.u32"), instrs[0]
            assert ".cc" not in instrs[-1].split()[0], instrs[-1]
            assert len(ops) <= 30
            n += 1
    assert n == 2 + 2 + 1


@pytest.mark.parametrize("which", ["edges", "random"])
def test_ptx_product_is_the_montgomery_integer(which):
    rng = random.Random(384)
    if which == "edges":
        pairs = [(x, y) for x in EDGE for y in EDGE]
    else:
        pairs = [(rng.randrange(2 * Q), rng.randrange(2 * Q)) for _ in range(300)]
        pairs += [(2 * Q - 1 - rng.randrange(1 << 64), 2 * Q - rng.randrange(1 << 32))
                  for _ in range(20)]
    for x, y in pairs:
        got = _mul_ptx_host(x, y)
        assert got == _mont(x, y), (x, y)
        assert got < 2 * Q


# -- the schedule: roles, steps and exchanges as the kernel runs them --------------


def _table(name):
    src = (CSRC / "g1_fused.cu").read_text()
    body = re.search(r"int8_t " + name + r"\[\d+\]\[\d+\] = \{(.*?)\};", src, re.S).group(1)
    return [tuple(int(v) for v in row.split(","))
            for row in re.findall(r"\{([-\d, ]+)\}", body)]


ADD_L1, MADD_L1, L2 = _table("G1S_ADD_L1"), _table("G1S_MADD_L1"), _table("G1S_L2")
DBL_L1, DBL_L2, DBL_OUT = _table("G1S_DBL_L1"), _table("G1S_DBL_L2"), _table("G1S_DBL_OUT")
P2 = 2 * Q


def _add(a, b):
    s = a + b
    return s - P2 if s >= P2 else s


def _sub(a, b):
    s = a + P2 - b
    return s - P2 if s >= P2 else s


def _mul3(a):
    s = 3 * a
    s = s - P2 if s >= P2 else s
    return s - P2 if s >= P2 else s


class _Shared(dict):
    """Shared memory of one step: a slot is written once, and read only in
    a later step."""

    def put(self, k, v):
        assert k not in self, f"slot {k} written twice"
        self[k] = v


def _add_derive(j, s1, s2, pt):
    if j == 4:
        b = _mul3(s1[2])
        s2.put(4, _add(s1[1], b))
        s2.put(5, _sub(s1[1], b))
    elif j == 3:
        s2.put(3, _mul3(s1[0]))
    else:
        u, w = (1 if j == 1 else 0), (1 if j == 0 else 2)
        d = _sub(s1[3 + j], _add(s1[u], s1[w]))
        s2.put(j, _mul3(d) if j == 2 else d)


def _madd_derive(j, s1, s2, pt):
    x1, y1, z1 = pt
    if j == 0:
        s2.put(0, _sub(s1[2], _add(s1[0], s1[1])))
    elif j == 1:
        s2.put(1, _add(s1[3], y1))
    elif j == 2:
        s2.put(2, _mul3(_add(s1[4], x1)))
    elif j == 3:
        s2.put(3, _add(_add(s1[0], s1[0]), s1[0]))
    else:
        b = _mul3(z1)
        s2.put(4, _add(s1[1], b))
        s2.put(5, _sub(s1[1], b))


def _dbl_derive(j, s1, s2, pt):
    if j == 0:
        e = _add(s1[0], s1[0])
        e = _add(e, e)
        s2.put(1, _add(e, e))                       # e = 8 t0
    elif j == 1:
        b = _mul3(s1[2])                            # b3 t2
        s2.put(0, b)
        s2.put(4, _add(s1[0], b))                   # y3 = t0 + b3 t2
        s2.put(3, _sub(s1[0], _mul3(b)))            # t0 = t0 - 3 b3 t2
    else:
        s2.put(2, s1[1])
        s2.put(5, s1[3])


def _operand(coords, u, w, neg_y):
    pick = lambda k: (P2 - coords[k]) if (k == 1 and neg_y) else coords[k]
    return _add(pick(u), pick(w)) if w >= 0 else pick(u)


# G1S_ADD, G1S_MADD_SEL, G1S_ADD_SEL_PROJ, G1S_DOUBLE
MODES = ("add", "madd_sel", "add_sel_proj", "double")


def _schedule_host(roles, acc, addend, mode, sign=0, valid=1, mul=_mul_ptx_host):
    """One lane of g1s_body<mode> with `roles` roles -> (x3, y3, z3) as ints.
    The doubling's addend is its own point (`addend` is not read)."""
    assert mode in MODES
    mixed, double = mode == "madd_sel", mode == "double"
    if mode in ("madd_sel", "add_sel_proj") and (not valid or (mixed and addend[1] == 0)):
        return acc                                  # the copy, split over roles
    neg_y = bool(mode in ("madd_sel", "add_sel_proj") and sign)
    if double:
        addend = acc
        l1, derive, jobs, l2 = DBL_L1, _dbl_derive, 3, DBL_L2
    else:
        l1, derive, jobs, l2 = (MADD_L1, _madd_derive, 5, L2) if mixed else (
            ADD_L1, _add_derive, 5, L2)
    s1, s2, s3 = _Shared(), _Shared(), _Shared()
    for r in range(roles):                          # level 1
        for j in range(r, len(l1), roles):
            u1, v1, u2, v2 = l1[j]
            s1.put(j, mul(_operand(acc, u1, v1, False), _operand(addend, u2, v2, neg_y)))
    for r in range(roles):                          # __syncthreads, derive
        for j in range(r, jobs, roles):
            derive(j, s1, s2, acc)
    for r in range(roles):                          # __syncthreads, level 2
        for j in range(r, len(l2), roles):
            s3.put(j, mul(s2[l2[j][0]], s2[l2[j][1]]))
    out = [None] * 3
    for r in range(roles):                          # __syncthreads, final
        for c in range(r, 3, roles):
            if double:
                u, v = DBL_OUT[c]
                out[c] = _add(s3[u], s3[v]) if v >= 0 else s3[u]
            else:
                out[c] = (_sub if c == 0 else _add)(s3[2 * c], s3[2 * c + 1])
    return tuple(out)


KINDS = ("P+P", "P+(-P) by value", "P+(-P) by sign", "identity+P", "P+identity",
         "identity+identity, z=0", "identity+identity, z=p", "sentinel addend",
         "invalid lane", "P+P, lazy representatives")


def _lanes(rng, m):
    """chip_smoke.py's _g1_inputs on host integers: random lazy lanes with
    every kind of KINDS planted in turn."""
    one = (1 << 384) % Q
    c = {k: [rng.randrange(2 * Q) for _ in range(m)] for k in ("x1", "y1", "z1", "x2", "z2")}
    c["y2"] = [rng.randrange(1, 2 * Q) for _ in range(m)]
    sign = [rng.randrange(2) for _ in range(m)]
    valid = [1] * m
    period = max(1, min(97, m // len(KINDS)))
    for k in range(0, m, period):
        kind = (k // period) % len(KINDS)
        a, b = c["x1"][k] % Q, c["y1"][k] % Q or 1
        c["x1"][k], c["y1"][k], c["z1"][k] = a, b, one
        c["x2"][k], c["y2"][k], c["z2"][k], sign[k] = a, b, one, 0
        if kind == 1:
            c["y2"][k] = Q - b
        elif kind == 2:
            sign[k] = 1
        elif kind == 3:
            c["x1"][k], c["y1"][k], c["z1"][k] = 0, one, 0
        elif kind == 4:
            c["x2"][k], c["y2"][k], c["z2"][k] = 0, 0, 0
        elif kind == 5:
            c["x1"][k], c["y1"][k], c["z1"][k] = 0, one, 0
            c["x2"][k], c["y2"][k], c["z2"][k] = 0, one, 0
        elif kind == 6:
            c["x1"][k], c["y1"][k], c["z1"][k] = Q, one + Q, Q
            c["x2"][k], c["y2"][k], c["z2"][k] = Q, one, Q
        elif kind == 7:
            c["x2"][k], c["y2"][k], sign[k] = 0, 0, 1
        elif kind == 8:
            valid[k], c["y1"][k] = 0, 2 * Q
        elif kind == 9:
            c["x2"][k], c["y2"][k], c["z1"][k] = a + Q, b + Q, one + Q
    return c, sign, valid


def _t(vals):
    return limbs.to_tensor(limbs.ints_to_limbs(vals, L).T, "cpu")


def _ints(t):
    return limbs.limbs_to_ints(np.asarray(t).astype(np.int64).T)


def _j(vals):
    return jnp.asarray(limbs.ints_to_limbs([v % Q for v in vals], L).T.astype(np.uint32))


@pytest.fixture(scope="module")
def lanes():
    c, sign, valid = _lanes(random.Random(20240229 + 11), 40)
    return {"c": c, "sign": sign, "valid": valid}


@pytest.mark.parametrize("roles", [2, 3, 6])
def test_add_schedule_matches_plain_and_jax(lanes, roles):
    c = lanes["c"]
    m = len(c["x1"])
    got = [_schedule_host(roles, (c["x1"][k], c["y1"][k], c["z1"][k]),
                          (c["x2"][k], c["y2"][k], c["z2"][k]), "add")
           for k in range(m)]
    plain = tgf._add_plain(*(_t(c[k]) for k in ("x1", "y1", "z1", "x2", "y2", "z2")))
    ref = jgf.add_lf(jgf.G1LF(_j(c["x1"]), _j(c["y1"]), _j(c["z1"])),
                     jgf.G1LF(_j(c["x2"]), _j(c["y2"]), _j(c["z2"])))
    for i in range(3):
        mine = [g[i] for g in got]
        assert all(v < 2 * Q for v in mine)
        assert [v % Q for v in mine] == [v % Q for v in _ints(plain[i])]
        assert [v % Q for v in mine] == [v % Q for v in _ints(ref[i])]


@pytest.mark.parametrize("roles", [2, 3, 6])
def test_add_sel_schedule_matches_plain_and_jax(lanes, roles):
    c, sign, valid = lanes["c"], lanes["sign"], lanes["valid"]
    m = len(c["x1"])
    got = [_schedule_host(roles, (c["x1"][k], c["y1"][k], c["z1"][k]), (c["x2"][k], c["y2"][k]),
                          "madd_sel", sign=sign[k], valid=valid[k])
           for k in range(m)]
    flag = lambda v: torch.tensor([v], dtype=torch.int32)
    plain = tgf._add_sel_plain(*(_t(c[k]) for k in ("x1", "y1", "z1", "x2", "y2")),
                               flag(sign), flag(valid))
    ref = jgf.add_sel_lf(jgf.G1LF(_j(c["x1"]), _j(c["y1"]), _j(c["z1"])),
                         _j(c["x2"]), _j(c["y2"]),
                         jnp.asarray(np.array(sign, dtype=np.uint32)),
                         jnp.asarray(np.array(valid, dtype=np.uint32)))
    masked = [k for k in range(m) if not valid[k] or c["y2"][k] == 0]
    assert 0 < len(masked) < m
    for i, name in enumerate(("x1", "y1", "z1")):
        mine = [g[i] for g in got]
        assert [mine[k] for k in masked] == [c[name][k] for k in masked]   # bit for bit
        assert [v % Q for v in mine] == [v % Q for v in _ints(plain[i])]
        assert [v % Q for v in mine] == [v % Q for v in _ints(ref[i])]


def test_schedule_tables_have_the_products_of_their_algorithms():
    """12 products for Alg. 7 and 11 for Alg. 8, each level's operands
    distinct; level 2 reads every derived value twice."""
    assert len(ADD_L1) + len(L2) == 12 and len(MADD_L1) + len(L2) == 11
    assert len(set(ADD_L1)) == 6 and len(set(MADD_L1)) == 5
    assert sorted(v for pair in L2 for v in pair) == sorted(list(range(6)) * 2)
    assert all(u2 < 2 and v2 < 2 for _, _, u2, v2 in MADD_L1), "an affine addend has no z"


@pytest.mark.parametrize("roles", [2, 3, 6])
def test_add_sel_proj_schedule_matches_plain_and_jax(lanes, roles):
    """g1_add_sel_proj: Alg. 7 with the sign on y2 and the valid mask alone
    (an identity addend, z2 = 0, goes through the formula). One lane in
    three is masked on top of the planted invalid lane."""
    c, sign = lanes["c"], lanes["sign"]
    m = len(c["x1"])
    valid = [v if k % 3 else 0 for k, v in enumerate(lanes["valid"])]
    got = [_schedule_host(roles, (c["x1"][k], c["y1"][k], c["z1"][k]),
                          (c["x2"][k], c["y2"][k], c["z2"][k]), "add_sel_proj",
                          sign=sign[k], valid=valid[k])
           for k in range(m)]
    flag = lambda v: torch.tensor([v], dtype=torch.int32)
    plain = tgf._add_sel_proj_plain(*(_t(c[k]) for k in ("x1", "y1", "z1", "x2", "y2", "z2")),
                                    flag(sign), flag(valid))
    ref = jgf.add_sel_proj_lf(jgf.G1LF(_j(c["x1"]), _j(c["y1"]), _j(c["z1"])),
                              jgf.G1LF(_j(c["x2"]), _j(c["y2"]), _j(c["z2"])),
                              jnp.asarray(np.array(sign, dtype=np.uint32)),
                              jnp.asarray(np.array(valid, dtype=np.uint32)))
    masked = [k for k in range(m) if not valid[k]]
    assert 0 < len(masked) < m and any(sign[k] for k in range(m) if valid[k])
    for i, name in enumerate(("x1", "y1", "z1")):
        mine = [g[i] for g in got]
        assert [mine[k] for k in masked] == [c[name][k] for k in masked]   # bit for bit
        assert all(mine[k] < 2 * Q for k in range(m) if valid[k])
        assert [v % Q for v in mine] == [v % Q for v in _ints(plain[i])]
        assert [v % Q for v in mine] == [v % Q for v in _ints(ref[i])]


def test_adders_run_their_modes_on_the_role_split():
    """Each adder kernel is g1s_body in its own mode and is launched with a
    block of G1S_THREADS threads for G1S_LANES lanes, as the host model
    assumes."""
    src = (CSRC / "g1_fused.cu").read_text()
    enum = re.search(r"enum G1sMode \{([^}]*)\}", src).group(1)
    assert [v.strip() for v in enum.split(",")] == ["G1S_ADD", "G1S_MADD_SEL", "G1S_ADD_SEL_PROJ",
                                                    "G1S_DOUBLE"]
    for kernel, mode in (("g1_add", "G1S_ADD"), ("g1_add_sel", "G1S_MADD_SEL"),
                         ("g1_add_sel_proj", "G1S_ADD_SEL_PROJ")):
        body = re.search(r"\n" + kernel + r"_kernel\(.*?\) \{(.*?)\n\}", src, re.S).group(1)
        assert re.fullmatch(r"\s*g1s_body<" + mode + r">\(.*\);\s*", body, re.S), kernel
        launch = re.search(kernel + r"_kernel<<<(.*?)>>>", src).group(1)
        assert launch.replace(" ", "") == "g1s_blocks(M),G1S_THREADS,0,(cudaStream_t)stream"
    assert "fq_mul(" not in src.split("enum G1sMode")[1], "the adders' products are fq_mul_ptx"
    # the masks of g1_add_sel_proj, as _schedule_host takes them: the sign on
    # y2 and the valid word alone
    proj = re.search(r"if constexpr \(MODE == G1S_ADD_SEL_PROJ\) \{\s*if \(live\) \{(.*?)\}",
                     src, re.S).group(1)
    assert sorted(" ".join(st.split()) for st in proj.split(";") if st.strip()) == [
        "keep = validp[m] != 0", "neg_y = signp[m] != 0"]


def _dbl_lanes(rng):
    """Points for the doubling: random lazy lanes (< 2p), lanes at 2p and
    2p - 1 in every coordinate, lazy representatives (v + p), and the
    identity stored as (0, 1, 0), with z = p, and with lazy x and y."""
    one = (1 << 384) % Q
    pts = [tuple(rng.randrange(2 * Q) for _ in range(3)) for _ in range(10)]
    a, b = rng.randrange(Q), rng.randrange(1, Q)
    pts += [(2 * Q, 2 * Q, 2 * Q), (2 * Q - 1, 2 * Q, 2 * Q - 1), (2 * Q, 2 * Q - 1, one + Q),
            (a + Q, b + Q, one + Q), (a, 2 * Q, one),
            (0, one, 0), (Q, one + Q, Q), (2 * Q, one, 2 * Q), (a + Q, b, 0)]
    return pts


@pytest.mark.parametrize("roles", [4, 6])
def test_double_schedule_matches_plain_and_jax(roles):
    """g1_double: Alg. 9 on the role split, four products a level, against
    `_double_plain` and the JAX package's `double_lf`; lazy lanes up to 2p
    and the identity with z = 0 and z = p."""
    pts = _dbl_lanes(random.Random(20240229 + 9))
    got = [_schedule_host(roles, p, None, "double") for p in pts]
    cols = [[p[i] for p in pts] for i in range(3)]
    plain = tgf._double_plain(*(_t(c) for c in cols))
    ref = jgf.double_lf(jgf.G1LF(*(_j(c) for c in cols)))
    for i in range(3):
        mine = [g[i] for g in got]
        assert all(v < 2 * Q for v in mine)
        assert [v % Q for v in mine] == [v % Q for v in _ints(plain[i])]
        assert [v % Q for v in mine] == [v % Q for v in _ints(ref[i])]
    for k, p in enumerate(pts):
        if p[2] % Q == 0:
            assert got[k][2] % Q == 0, "twice the identity is the identity"


def test_double_runs_its_mode_on_the_role_split():
    """g1_double_kernel is g1s_body in the doubling mode with the point as
    its own addend, launched with G1S_DBL_ROLES roles over G1S_LANES lanes a
    block, as the host model assumes; its step sizes are the model's, and
    the file multiplies on fq_mul_ptx alone."""
    src = (CSRC / "g1_fused.cu").read_text()
    body = re.search(r"\ng1_double_kernel\(.*?\) \{(.*?)\n\}", src, re.S).group(1)
    assert " ".join(body.split()) == ("g1s_body<G1S_DOUBLE, G1S_DBL_ROLES>(xp, yp, zp, xp, yp, "
                                      "zp, nullptr, nullptr, oxp, oyp, ozp, M);")
    assert "__launch_bounds__(G1S_DBL_THREADS, G1S_DBL_MIN_BLOCKS)\ng1_double_kernel(" in src
    launch = re.search(r"g1_double_kernel<<<(.*?)>>>", src).group(1)
    assert launch.replace(" ", "") == "g1s_blocks(M),G1S_DBL_THREADS,0,(cudaStream_t)stream"
    assert "#define G1S_DBL_THREADS (G1S_DBL_ROLES * G1S_LANES)" in src
    roles = int(re.search(r"#define G1S_DBL_ROLES (\d+)", src).group(1))
    assert roles in (4, 6), "test_double_schedule_matches_plain_and_jax runs the kept count"
    steps = re.search(r"constexpr int N1 = (.*?);", src).group(1)
    assert " ".join(steps.split()) == "DOUBLE ? 4 : (MIXED ? 5 : 6), ND = DOUBLE ? 3 : 5, N2 = DOUBLE ? 4 : 6"
    assert (len(DBL_L1), len(DBL_L2), len(DBL_OUT)) == (4, 4, 3)
    assert all(v1 < 0 and v2 < 0 for _, v1, _, v2 in DBL_L1), "Alg. 9 multiplies coordinates"
    assert "fq_mul(" not in src and "g1_double_core" not in src
    assert re.search(r"void g1s_dbl_derive\((?:.*?)\) \{(.*?)\n\}", src, re.S).group(1).count(
        "fq_mul_ptx(") == 0


# -- fq_apply: the kernel's statements, executed on the host ------------------------


def _apply_source():
    src = (CSRC / "g1_affine.cu").read_text()
    body = re.search(r"\nfq_apply_kernel\(.*?\) \{(.*?)\n\}", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    consts = {k: int(v) for k, v in re.findall(r"#define (CASE_\w+) (\d+)", src)}
    return src, body, consts


APPLY_SRC, APPLY_BODY, APPLY_CONSTS = _apply_source()
APPLY_STATEMENTS = [" ".join(st.split()) for st in APPLY_BODY.split(";") if st.strip()]


def _cond(expr, env):
    """A C expression of the kernel: names, ==, !=, >=, ||, and reads p[m]
    of a flag (env["lane"][p])."""
    expr = re.sub(r"(\w+)\[m\]", lambda m: str(env["lane"][m.group(1)]), expr)
    return eval(expr.replace("||", " or "), {}, env)


def _apply_host(lane, mul=_mul_ptx_host):
    """One lane of fq_apply_kernel, statement for statement as the source
    spells it. lane maps the kernel's pointer names (x1p, ..., invp; flags
    casep, signp, inf1p) to ints -> ({output pointer: int}, the number of
    products). A value used before it was loaded or computed fails."""
    env = {**APPLY_CONSTS, "lane": lane, "m": 0, "M": 1}
    out, products = {}, 0

    def run(st):
        nonlocal products
        if st.startswith("uint32_t "):
            return
        if m := re.fullmatch(r"if \((.+?)\) (.+)", st):
            if _cond(m.group(1), env):
                run(m.group(2))
        elif st == "return":
            raise AssertionError("the lane returned early")
        elif st == "long m = (long)blockIdx.x * FQA_LANES + threadIdx.x":
            env["m"] = 0                                    # the one lane, of one
        elif m := re.fullmatch(r"(?:long|int|bool) (.*)", st):
            for part in m.group(1).split(", "):
                name, expr = part.split(" = ")
                env[name] = _cond(expr, env)
        elif m := re.fullmatch(r"fq_load\((\w+), (\w+), ld, m\)", st):
            env[m.group(1)] = lane[m.group(2)]
        elif m := re.fullmatch(r"fq_mul_ptx\((\w+), (\w+), (\w+)\)", st):
            env[m.group(1)] = mul(env[m.group(2)], env[m.group(3)])
            products += 1
        elif m := re.fullmatch(r"fq_sub\((\w+), (\w+), (\w+)\)", st):
            env[m.group(1)] = _sub(env[m.group(2)], env[m.group(3)])
        elif m := re.fullmatch(r"fq_neg\((\w+), (\w+)\)", st):
            env[m.group(1)] = P2 - env[m.group(2)]
        elif m := re.fullmatch(r"fq_select\((\w+), (.+), (\w+), (\w+)\)", st):
            env[m.group(1)] = env[m.group(3)] if _cond(m.group(2), env) else env[m.group(4)]
        elif m := re.fullmatch(r"fq_store\((\w+), ld, m, (\w+)\)", st):
            out[m.group(1)] = env[m.group(2)]
        elif m := re.fullmatch(r"(\w+) = (\w+)", st):
            env[m.group(1)] = _cond(m.group(2), env)
        elif m := re.fullmatch(r"(\w+)\[m\] = (\w+)", st):
            out[m.group(1)] = env[m.group(2)]
        else:
            raise AssertionError(f"fq_apply_kernel: no host model for `{st}`")

    for st in APPLY_STATEMENTS:
        run(st)
    return out, products


def _affine_lanes(rng, m):
    """chip_smoke.py's _grid_inputs on host integers: random lazy lanes with
    tangent, cancellation, identity and invalid lanes planted, a kind every
    few lanes so that all four case codes occur."""
    c = {k: [rng.randrange(2 * Q) for _ in range(m)] for k in ("x1", "x2")}
    c.update({k: [rng.randrange(1, 2 * Q) for _ in range(m)] for k in ("y1", "y2")})
    c.update(inf1=[0] * m, inf2=[0] * m, valid=[1] * m,
             sign=[rng.randrange(2) for _ in range(m)])
    for k in range(0, m, 3):
        kind = (k // 3) % 8
        a, b = c["x1"][k] % Q, c["y1"][k] % Q or 1
        c["x1"][k], c["y1"][k] = a, b
        c["x2"][k], c["y2"][k], c["sign"][k] = [(a, b, 0), (a + Q, Q - b, 1), (a, Q - b, 0),
                                                (a + Q, b, 1)][kind % 4]
        if kind == 4:
            c["inf1"][k], c["x1"][k], c["y1"][k] = 1, 0, 0
        elif kind == 5:
            c["inf2"][k], c["x2"][k], c["y2"][k] = 1, 0, 0
        elif kind == 6:
            c["inf1"][k], c["inf2"][k], c["x1"][k], c["y1"][k] = 1, 1, 0, 0
            c["x2"][k], c["y2"][k] = 0, 0
        elif kind == 7:
            c["valid"][k] = 0
    return c


@pytest.fixture(scope="module", params=["canonical", "lazy"])
def apply_lanes(request):
    """The inputs of fq_apply as madd gives them: fq_prepare's (plain)
    numerators and case codes and the inverses of its denominators, at 48
    seeded lanes; "lazy": then every operand but the flags lifted to its
    other representative (v + p) on every other lane, each operand on lanes
    of its own."""
    m = 48
    c = _affine_lanes(random.Random(20240229 + 5), m)
    flag = lambda v: torch.tensor([v], dtype=torch.int32)
    d, num, case = tga._prepare_plain(_t(c["x1"]), _t(c["y1"]), flag(c["inf1"]), _t(c["x2"]),
                                      _t(c["y2"]), flag(c["inf2"]), flag(c["sign"]),
                                      flag(c["valid"]))
    c.update(num=_ints(num), inv=_ints(tga._fermat_plain(d)), case=case[0].tolist())
    assert sorted(set(c["case"])) == [0, 1, 2, 3], "every case code is planted"
    if request.param == "lazy":
        for i, k in enumerate(("x1", "y1", "x2", "y2", "num", "inv")):
            c[k] = [v + Q if v < Q and (j + i) % 2 else v for j, v in enumerate(c[k])]
        assert all(any(v >= Q for v in c[k]) for k in ("x1", "num", "inv"))
    plain = tga._apply_plain(_t(c["x1"]), _t(c["y1"]), flag(c["inf1"]), _t(c["x2"]),
                             _t(c["y2"]), flag(c["sign"]), flag(c["case"]), _t(c["num"]),
                             _t(c["inv"]))
    rows = {k: jnp.asarray(v[:, None]) for k, v in jga._fq().rows.items()}
    jflag = lambda v: jnp.asarray(np.array([v], dtype=np.uint32))
    jraw = lambda v: jnp.asarray(limbs.ints_to_limbs(v, L).T.astype(np.uint32))
    ref = jga._apply_body(rows, jraw(c["x1"]), jraw(c["y1"]), jflag(c["inf1"]), jraw(c["x2"]),
                          jraw(c["y2"]), jflag(c["sign"]), jflag(c["case"]), jraw(c["num"]),
                          jraw(c["inv"]))
    return c, plain, ref


def test_apply_sequence_matches_plain_and_jax(apply_lanes):
    """fq_apply_kernel's statements against the plain version and the JAX
    package's body: stored limbs and flags bit for bit, all four case codes,
    on canonical inputs and with lazy representatives on half the lanes."""
    c, plain, ref = apply_lanes
    got = []
    for k in range(len(c["x1"])):
        lane = {p + "p": c[p][k] for p in ("x1", "y1", "x2", "y2", "num", "inv")}
        lane.update(casep=c["case"][k], signp=c["sign"][k], inf1p=c["inf1"][k])
        out, products = _apply_host(lane)
        assert set(out) == {"oxp", "oyp", "oinfp"} and products == 3
        got.append(out)
    for i, key in enumerate(("oxp", "oyp")):
        mine = [g[key] for g in got]
        assert mine == _ints(plain[i])                      # stored limbs, bit for bit
        assert mine == _ints(np.asarray(ref[i]))
    mine = [g["oinfp"] for g in got]
    assert mine == plain[2][0].tolist() == np.asarray(ref[2])[0].tolist()


def test_apply_multiplies_on_ptx():
    """fq_apply's three products are fq_mul_ptx (the square too), one
    thread a lane in blocks of FQA_LANES."""
    assert sum(st.startswith("fq_mul_ptx(") for st in APPLY_STATEMENTS) == 3
    assert not any(st.startswith(("fq_mul(", "fq_sq(")) for st in APPLY_STATEMENTS)
    assert "__launch_bounds__(FQA_LANES)\nfq_apply_kernel(" in APPLY_SRC
    launch = re.search(r"fq_apply_kernel<<<(.*?)>>>", APPLY_SRC, re.S).group(1)
    assert " ".join(launch.split()) == (
        "(unsigned)((M + FQA_LANES - 1) / FQA_LANES), FQA_LANES, 0, (cudaStream_t)stream")


# -- fq_mul: products on fq_mul_ptx, lanes strided over the grid -------------------


def _fq_mul_source():
    src = (CSRC / "g1_affine.cu").read_text()
    body = re.search(r"\nfq_mul_kernel\(.*?\) \{(.*?)\n\}", src, re.S).group(1)
    return src, re.sub(r"//[^\n]*", "", body)


def test_fq_mul_multiplies_on_ptx():
    """fq_mul_kernel's product is fq_mul_ptx, one for each lane a thread
    takes, none on fq_mul."""
    src, body = _fq_mul_source()
    assert body.count("fq_mul_ptx(") == 1 and "fq_mul(" not in body and "fq_sq(" not in body
    assert "__launch_bounds__(FQM_THREADS)\nfq_mul_kernel(" in src


def _fq_mul_lanes(m, k=None):
    """The lanes each thread of an fq_mul launch of m lanes multiplies, as
    the launcher sizes the grid and the kernel walks it, at k lanes a thread
    (default: the source's FQM_LANES) -> (count of products of each lane,
    the number of threads)."""
    src, body = _fq_mul_source()
    t = int(re.search(r"#define FQM_THREADS (\d+)", src).group(1))
    k = k or int(re.search(r"#define FQM_LANES (\d+)", src).group(1))
    flat = " ".join(body.split())
    assert flat.startswith("const long G = (long)gridDim.x * FQM_THREADS; "
                           "long m = (long)blockIdx.x * FQM_THREADS + threadIdx.x; #pragma unroll "
                           "for (int i = 0; i < FQM_LANES && m < M; i++, m += G) {"), flat
    launcher = " ".join(re.search(r"unsigned fqm_blocks\(int M\) \{(.*?)\}", src, re.S)
                        .group(1).split())
    assert launcher == ("return (unsigned)((M + FQM_THREADS * FQM_LANES - 1) / "
                        "(FQM_THREADS * FQM_LANES));")
    assert "fq_mul_kernel<<<fqm_blocks(M), FQM_THREADS, 0, (cudaStream_t)stream>>>" in src
    grid = (m + t * k - 1) // (t * k) * t
    hits = np.zeros(m, dtype=np.int64)
    first = np.arange(grid)
    for i in range(k):                      # lane g + i G while it is below m
        lanes = first + i * grid
        np.add.at(hits, lanes[lanes < m], 1)
    return hits, grid, t, k


@pytest.mark.parametrize("m", [1, 2, 31, 33, 127, 129, 50688, 180224])
def test_fq_mul_lane_map_covers_every_lane_once(m):
    """At the source's lanes a thread and at the 2 and 4 that
    scripts/torch_g1_variants.py builds: every lane once, and no block
    beyond what the lanes need."""
    for k in (None, 2, 4):
        hits, grid, t, k = _fq_mul_lanes(m, k)
        assert hits.min() == 1 and hits.max() == 1, k
        assert grid * k >= m and (grid - t) * k < m, k


# -- fq_mul_canon (csrc/proto_mul.cu): fq_mul_ptx and one subtraction ------------


def _canon_source():
    src = (CSRC / "proto_mul.cu").read_text()
    body = re.search(r"\nfq_mul_canon_kernel\(.*?\) \{(.*?)\n\}", src, re.S).group(1)
    return src, [" ".join(st.split()) for st in re.sub(r"//[^\n]*", "", body).split(";")
                 if st.strip()]


def test_fq_mul_canon_multiplies_on_ptx_and_subtracts_once():
    """fq_mul_canon_kernel's statements, read from the source, executed on
    the PTX host model: the product of operands up to 2q (the edge values
    and random ones) and one conditional subtraction of q give a*b*R^-1 mod
    q, canonical, equal to the plain version's limbs bit for bit."""
    from aleo_tpu_torch.fields import proto_mul as pm

    src, sts = _canon_source()
    assert sts == [
        "long m = (long)blockIdx.x * FQC_THREADS + threadIdx.x",
        "if (m >= M) return",
        "uint32_t x[FQ_WORDS], y[FQ_WORDS]",
        "fq_load(x, a, M, m)",
        "fq_load(y, b, M, m)",
        "fq_mul_ptx(x, x, y)",
        "fq_cond_sub(x, FQ_P)",
        "fq_store(out, M, m, x)",
    ], sts
    assert "__launch_bounds__(FQC_THREADS)\nfq_mul_canon_kernel(" in src
    assert '#include "fq_mul_ptx.cuh"' in src
    rng = random.Random(122)
    pairs = [(x, y) for x in EDGE[:-2] + [EDGE[-1]] for y in EDGE[:-2] + [EDGE[-1]]]
    pairs += [(rng.randrange(2 * Q), rng.randrange(2 * Q)) for _ in range(100)]
    rinv = pow(1 << 384, -1, Q)
    got = []
    for x, y in pairs:
        v = _mul_ptx_host(x, y)
        v = v - Q if v >= Q else v                 # fq_cond_sub(x, FQ_P)
        assert v == x * y * rinv % Q, (x, y)
        got.append(v)
    a = limbs.to_tensor(limbs.ints_to_limbs([x for x, _ in pairs], L).T.copy(), "cpu")
    b = limbs.to_tensor(limbs.ints_to_limbs([y for _, y in pairs], L).T.copy(), "cpu")
    want = pm.fq_mul_canon_plain(a, b)
    assert torch.equal(want, limbs.to_tensor(limbs.ints_to_limbs(got, L).T.copy(), "cpu"))


@pytest.mark.parametrize("m", [1, 31, 32, 33, 65536])
def test_fq_mul_canon_lane_map_covers_every_lane_once(m):
    """The grid of ceil(M / FQC_THREADS) blocks of FQC_THREADS threads (32,
    one warp, read from the source) with one lane a thread: every lane once,
    and no block beyond what the lanes need. fq_mul_chain12 and fr_mul keep
    their 128-thread blocks."""
    src, sts = _canon_source()
    t = int(re.search(r"#define FQC_THREADS (\d+)", src).group(1))
    assert t == 32 and int(re.search(r"#define PM_THREADS (\d+)", src).group(1)) == 128
    blocks = " ".join(re.search(r"unsigned fqc_blocks\(int M\) \{(.*?)\}", src, re.S)
                      .group(1).split())
    assert blocks == "return (unsigned)((M + FQC_THREADS - 1) / FQC_THREADS);"
    assert "fq_mul_canon_kernel<<<fqc_blocks(M), FQC_THREADS, 0, (cudaStream_t)stream>>>" in src
    for other in ("fq_mul_chain12", "fr_mul"):
        assert f"{other}_kernel<<<pm_blocks(M), PM_THREADS, 0," in src
    grid = (m + t - 1) // t
    lane = np.arange(grid)[:, None] * t + np.arange(t)[None, :]     # blockIdx.x * T + threadIdx.x
    hits = np.bincount(lane[lane < m], minlength=m)
    assert hits.min() == 1 and hits.max() == 1 and hits.size == m
    assert (grid - 1) * t < m <= grid * t
