"""Circuit synthesizer: Aleo programs -> R1CS constraints + witness.

The framework's analogue of snarkVM's circuit-synthesis half of
`Process::execute` (reference: `upstream:wasm/src/programs/macros.rs:85-87`
drives `process.execute` which synthesizes one R1CS circuit per transition;
constraint counts are reported the same way `aleo run` does at
`upstream:cli/commands/run.rs:64-95`).

Design: two passes.
  1. The host `Interpreter` executes the function, fixing all concrete
     values (outputs, created records, nonces).
  2. This module re-runs the function symbolically over `CV` circuit
     values, emitting constraints into a `ConstraintSystem`, and binds the
     public transcript of the transition to public-input variables.

Public input layout of a transition circuit (var 0 is the constant 1):
  [function domain tag,
   per function input: input ID       (record -> commitment, else psd2 hash),
   per function output: output ID     (record -> commitment, else psd2 hash)]

Scalar circuit values are carried as `LinearCombination`s so additions,
subtractions and constant scalings are free; only multiplications, bit
decompositions, and Poseidon S-boxes allocate witnesses/constraints.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Tuple

from .. import params
from ..reference import poseidon
from ..snark.r1cs import LC, ConstraintSystem
from .interpreter import ExecutionError, Interpreter, Registry, Transition
from .parser import Function, Instruction, Operand, Program
from .values import INT_WIDTHS, Record, Value, domain_tag, flatten, literal

R = params.R


class SynthesisError(Exception):
    pass


@dataclass
class CV:
    """Scalar circuit value: type + linear combination + concrete values.

    `fval` is the canonical Fr encoding (Value.as_field semantics: two's
    complement mod 2^w for signed ints); `raw` is the python-native value
    (signed int / bool) used to mirror interpreter semantics exactly.
    """

    type_: str
    lc: LC
    fval: int
    raw: object
    bits: Optional[List[int]] = None  # cached bit-variable indices (LSB first)


@dataclass
class StructCV:
    type_: str
    fields: Dict[str, object]  # name -> CV | StructCV


@dataclass
class RecordCV:
    program: str
    type_: str
    owner: CV
    gates: CV
    entries: Dict[str, object]
    nonce: CV


class Gadgets:
    """Constraint gadget library over a ConstraintSystem."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs

    # -- scalar plumbing -----------------------------------------------------

    def constant(self, c: int, type_: str = "field", raw=None) -> CV:
        c %= R
        return CV(type_, LC.constant(c), c, c if raw is None else raw)

    def witness(self, value: int, type_: str = "field", raw=None) -> CV:
        value %= R
        var = self.cs.alloc_witness(value)
        return CV(type_, LC.of(var), value, value if raw is None else raw)

    def mul(self, a: CV, b: CV, type_: str = "field") -> CV:
        out = self.cs.alloc_witness(a.fval * b.fval % R)
        self.cs.enforce(a.lc, b.lc, LC.of(out))
        return CV(type_, LC.of(out), a.fval * b.fval % R, None)

    def add(self, a: CV, b: CV, type_: str = "field") -> CV:
        return CV(type_, a.lc + b.lc, (a.fval + b.fval) % R, None)

    def sub(self, a: CV, b: CV, type_: str = "field") -> CV:
        return CV(type_, a.lc - b.lc, (a.fval - b.fval) % R, None)

    def scale(self, a: CV, k: int, type_: str = "field") -> CV:
        return CV(type_, a.lc.scale(k), a.fval * k % R, None)

    def enforce_eq(self, a: CV, b: CV) -> None:
        self.cs.enforce_eq(a.lc, b.lc)

    def enforce_zero(self, a: CV) -> None:
        self.cs.enforce_eq(a.lc, LC())

    # -- booleans ------------------------------------------------------------

    def alloc_bool(self, value: bool) -> CV:
        var = self.cs.alloc_witness(int(value))
        self.cs.assert_bool(var)
        return CV("boolean", LC.of(var), int(value), bool(value))

    def bool_not(self, a: CV) -> CV:
        return CV("boolean", LC.constant(1) - a.lc, (1 - a.fval) % R, not a.raw)

    def bool_and(self, a: CV, b: CV) -> CV:
        out = self.mul(a, b, "boolean")
        out.raw = bool(a.raw) and bool(b.raw)
        return out

    def bool_or(self, a: CV, b: CV) -> CV:
        # a + b - ab
        ab = self.mul(a, b)
        out = CV(
            "boolean",
            a.lc + b.lc - ab.lc,
            (a.fval + b.fval - ab.fval) % R,
            bool(a.raw) or bool(b.raw),
        )
        return out

    def bool_xor(self, a: CV, b: CV) -> CV:
        ab = self.mul(a, b)
        return CV(
            "boolean",
            a.lc + b.lc - ab.lc.scale(2),
            (a.fval + b.fval - 2 * ab.fval) % R,
            bool(a.raw) != bool(b.raw),
        )

    def select(self, c: CV, a: CV, b: CV, type_: str = None) -> CV:
        """c ? a : b — one constraint: c * (a - b) = r - b."""
        ty = type_ or a.type_
        rv = a.fval if c.raw else b.fval
        out = self.cs.alloc_witness(rv)
        self.cs.enforce(c.lc, a.lc - b.lc, LC.of(out) - b.lc)
        return CV(ty, LC.of(out), rv, a.raw if c.raw else b.raw)

    def is_zero(self, a: CV) -> CV:
        """b = (a == 0): alloc inv; a*inv = 1-b; a*b = 0."""
        b = 1 if a.fval == 0 else 0
        inv = pow(a.fval, -1, R) if a.fval else 0
        bv = self.cs.alloc_witness(b)
        iv = self.cs.alloc_witness(inv)
        self.cs.enforce(a.lc, LC.of(iv), LC.constant(1) - LC.of(bv))
        self.cs.enforce(a.lc, LC.of(bv), LC())
        return CV("boolean", LC.of(bv), b, bool(b))

    def eq_scalars(self, xs: List[CV], ys: List[CV]) -> CV:
        """AND over element-wise field equality of two flattened lists."""
        assert len(xs) == len(ys)
        acc = None
        for x, y in zip(xs, ys):
            e = self.is_zero(self.sub(x, y))
            acc = e if acc is None else self.bool_and(acc, e)
        return acc if acc is not None else self.constant(1, "boolean", True)

    # -- range / integer machinery -------------------------------------------

    def decompose(self, a: CV, nbits: int) -> List[int]:
        """Constrain a == sum b_i 2^i over nbits fresh boolean witnesses."""
        if a.bits is not None and len(a.bits) >= nbits:
            return a.bits[:nbits]
        v = a.fval
        assert v < (1 << nbits), f"value {v} exceeds {nbits} bits"
        bits = []
        acc = LC()
        for i in range(nbits):
            b = self.cs.alloc_witness((v >> i) & 1)
            self.cs.assert_bool(b)
            bits.append(b)
            acc = acc + LC.of(b, 1 << i)
        self.cs.enforce_eq(a.lc, acc)
        if a.bits is None:
            a.bits = bits
        return bits

    def unsigned_lt(self, a: CV, b: CV, w: int) -> CV:
        """a < b for w-bit unsigned encodings: top bit of (a - b + 2^w)."""
        shifted = CV("field", a.lc - b.lc + LC.constant(1 << w),
                     (a.fval - b.fval + (1 << w)) % R, None)
        bits = self.decompose(shifted, w + 1)
        gev = (shifted.fval >> w) & 1  # 1 iff a >= b
        return CV("boolean", LC.constant(1) - LC.of(bits[w]), 1 - gev, gev == 0)


# ---------------------------------------------------------------------------
# in-circuit Poseidon (mirrors reference.poseidon exactly)
# ---------------------------------------------------------------------------


class PoseidonGadget:
    def __init__(self, g: Gadgets, rate: int):
        self.g = g
        self.p = poseidon.PoseidonParams.standard(rate)
        self.rate = rate

    def _sbox(self, x: CV) -> CV:
        # x^17 = ((((x^2)^2)^2)^2) * x
        y = x
        for _ in range(4):
            y = self.g.mul(y, y)
        return self.g.mul(y, x)

    def permute(self, state: List[CV]) -> List[CV]:
        g, p = self.g, self.p
        t = p.t
        s = list(state)
        half = p.full_rounds // 2
        total = p.full_rounds + p.partial_rounds
        for rnd in range(total):
            s = [CV("field", s[i].lc + LC.constant(p.ark[rnd][i]),
                    (s[i].fval + p.ark[rnd][i]) % R, None) for i in range(t)]
            if rnd < half or rnd >= half + p.partial_rounds:
                s = [self._sbox(x) for x in s]
            else:
                s[0] = self._sbox(s[0])
            s = [
                CV(
                    "field",
                    sum((s[j].lc.scale(p.mds[i][j]) for j in range(1, t)),
                        s[0].lc.scale(p.mds[i][0])),
                    sum(p.mds[i][j] * s[j].fval for j in range(t)) % R,
                    None,
                )
                for i in range(t)
            ]
        return s

    def hash(self, inputs: List[CV], domain: str) -> CV:
        """In-circuit twin of reference.poseidon.hash_psd (snarkVM hash_many
        convention: zero state, preimage [domain, len] ++ inputs)."""
        g = self.g
        state = [g.constant(0) for _ in range(self.p.t)]
        pos = 0
        elements = [
            g.constant(poseidon.domain_fe(f"{domain}{self.rate}")),
            g.constant(len(inputs)),
        ] + inputs
        for e in elements:
            if pos == self.rate:
                state = self.permute(state)
                pos = 0
            state[1 + pos] = g.add(state[1 + pos], e)
            pos += 1
        state = self.permute(state)
        return state[1]


# ---------------------------------------------------------------------------
# in-circuit Pedersen / BHP over Edwards-BLS12 (mirrors reference.pedersen)
# ---------------------------------------------------------------------------


class PedersenGadget:
    """Edwards-curve hash gadgets: `hash.ped*` / `hash.bhp*` / `commit.*`.

    Edwards-BLS12 coordinates are Fr elements, so the whole group law lives
    natively in the R1CS field — the reason Aleo's in-circuit hashes use
    this curve. Complete twisted-Edwards addition: 7 constraints/add;
    Pedersen bit: one conditional add (selector is linear in the bit); BHP
    3-bit chunk: 2 muls (indicator product, sign flip) + one add.
    Mirrors reference.pedersen exactly (same generators).
    """

    def __init__(self, g: Gadgets):
        self.g = g
        self.a = params.EDWARDS_A
        self.d = params.EDWARDS_D

    def _edwards_add(self, P, Q):
        """Complete twisted-Edwards addition over CV coordinate pairs."""
        g = self.g
        x1, y1 = P
        x2, y2 = Q
        x1x2 = g.mul(x1, x2)
        y1y2 = g.mul(y1, y2)
        x1y2 = g.mul(x1, y2)
        y1x2 = g.mul(y1, x2)
        t = g.mul(x1x2, y1y2)              # x1 x2 y1 y2
        dt = g.scale(t, self.d)
        # x3 (1 + d t) = x1 y2 + y1 x2 ; y3 (1 - d t) = y1 y2 - a x1 x2
        x3v = (x1y2.fval + y1x2.fval) * pow((1 + dt.fval) % R, -1, R) % R
        y3v = (y1y2.fval - self.a * x1x2.fval) * pow((1 - dt.fval) % R, -1, R) % R
        x3 = g.witness(x3v)
        y3 = g.witness(y3v)
        g.cs.enforce(x3.lc, LC.constant(1) + dt.lc, x1y2.lc + y1x2.lc)
        g.cs.enforce(y3.lc, LC.constant(1) - dt.lc,
                     y1y2.lc - x1x2.lc.scale(self.a))
        return (x3, y3)

    def _identity(self):
        g = self.g
        return (g.constant(0), g.constant(1))

    def _cond_add_const(self, acc, b: CV, point):
        """acc + (b ? point : identity); the selector is linear in b."""
        g = self.g
        gx, gy = point
        sx = g.scale(b, gx)
        sy = CV("field", LC.constant(1) + b.lc.scale((gy - 1) % R),
                (1 + b.fval * (gy - 1)) % R, None)
        return self._edwards_add(acc, (sx, sy))

    def hash_point(self, bit_cvs, domain: str, use_bhp: bool):
        """Accumulated Edwards point (x, y) over boolean-constrained bits."""
        from ..reference import pedersen as ped

        g = self.g
        acc = self._identity()
        if not use_bhp:
            for i, b in enumerate(bit_cvs):
                acc = self._cond_add_const(
                    acc, b, ped.derive_generator(domain, i)
                )
            return acc
        bits = list(bit_cvs)
        while len(bits) % 3:
            bits.append(g.constant(0, "boolean", False))
        for i in range(0, len(bits), 3):
            b0, b1, b2 = bits[i], bits[i + 1], bits[i + 2]
            gp = ped.derive_generator(domain, i // 3)
            mults = [ped.edwards.mul(k, gp) for k in (1, 2, 3, 4)]
            p01 = g.mul(b0, b1)
            # (1 + b0 + 2 b1) G selected via indicators over (b0, b1):
            # ind = [1-b0-b1+p, b0-p, b1-p, p] — all linear given p = b0 b1

            def sel(coord):
                vals = [m[coord] for m in mults]
                lc = (
                    LC.constant(vals[0])
                    + b0.lc.scale((vals[1] - vals[0]) % R)
                    + b1.lc.scale((vals[2] - vals[0]) % R)
                    + p01.lc.scale((vals[0] - vals[1] - vals[2] + vals[3]) % R)
                )
                fv = (
                    vals[0]
                    + b0.fval * (vals[1] - vals[0])
                    + b1.fval * (vals[2] - vals[0])
                    + p01.fval * (vals[0] - vals[1] - vals[2] + vals[3])
                ) % R
                return CV("field", lc, fv, None)

            sx, sy = sel(0), sel(1)
            # sign: x' = (1 - 2 b2) sx  (Edwards negation flips x only)
            q = g.mul(b2, sx)
            xs = CV("field", sx.lc - q.lc.scale(2),
                    (sx.fval - 2 * q.fval) % R, None)
            acc = self._edwards_add(acc, (xs, sy))
        return acc

    def hash(self, bit_cvs, domain: str, use_bhp: bool) -> CV:
        out = self.hash_point(bit_cvs, domain, use_bhp)[0]
        out.type_ = "field"
        return out

    def commit(self, bit_cvs, r_bit_cvs, domain: str, use_bhp: bool) -> CV:
        """hash point + r*H via fixed-base conditional adds of 2^i H."""
        from ..reference import pedersen as ped

        acc = self.hash_point(bit_cvs, domain, use_bhp)
        cur = ped.derive_generator(domain + "/blind", 0)
        for b in r_bit_cvs:
            acc = self._cond_add_const(acc, b, cur)
            cur = ped.edwards.double(cur)
        out = acc[0]
        out.type_ = "field"
        return out


# ---------------------------------------------------------------------------
# the synthesizer
# ---------------------------------------------------------------------------


@dataclass
class Synthesis:
    cs: ConstraintSystem
    transition: Transition
    public_inputs: List[int]
    constraint_counts: Dict[str, int]


class Synthesizer:
    """Builds the R1CS transition circuit for one function execution."""

    def __init__(self, registry: Registry):
        self.registry = registry
        self.interp = Interpreter(registry)

    # -- value <-> circuit conversion ---------------------------------------

    def _witness_value(self, g: Gadgets, v, prog: Program):
        if isinstance(v, Record):
            owner = g.witness(v.owner, "address", v.owner)
            gates = g.witness(v.gates, "u64", v.gates)
            g.decompose(gates, 64)
            entries = {
                k: self._witness_value(g, val, prog) for k, val in v.entries.items()
            }
            nonce = g.witness(v.nonce, "field", v.nonce)
            return RecordCV(v.program, v.type_, owner, gates, entries, nonce)
        assert isinstance(v, Value)
        if isinstance(v.data, dict):
            return StructCV(
                v.type_,
                {k: self._witness_value(g, val, prog) for k, val in v.data.items()},
            )
        ty = v.type_
        cv = g.witness(v.as_field(), ty, v.data)
        if ty == "boolean":
            g.cs.assert_bool(next(iter(cv.lc.terms)))
        elif ty in INT_WIDTHS:
            g.decompose(cv, INT_WIDTHS[ty])
        return cv

    def _flatten(self, g: Gadgets, v) -> List[CV]:
        """Circuit twin of values.flatten."""
        if isinstance(v, StructCV):
            out = [g.constant(domain_tag(v.type_))]
            for name in sorted(v.fields):
                out.extend(self._flatten(g, v.fields[name]))
            return out
        if isinstance(v, RecordCV):
            raise SynthesisError("records do not flatten as plaintext")
        return [v]

    def _record_commitment(self, g: Gadgets, psd: PoseidonGadget, r: RecordCV) -> CV:
        flat = [
            g.constant(domain_tag(r.program)),
            g.constant(domain_tag(r.type_)),
            r.owner,
            r.gates,
        ]
        for name, v in r.entries.items():
            flat.extend(self._flatten(g, v))
        flat.append(r.nonce)
        return psd.hash(flat, domain="aleo-tpu/record-commit")

    # -- main entry ----------------------------------------------------------

    def synthesize(
        self,
        program_id: str,
        function: str,
        inputs: List[Value | Record],
        caller: int = 0,
        rng_nonce=None,
    ) -> Synthesis:
        prog = self.registry.get(program_id)
        fn = prog.functions.get(function)
        if fn is None:
            raise SynthesisError(f"unknown function {program_id}/{function}")

        # Pass 1: concrete execution (fixes outputs and record nonces).
        nonces: List[int] = []
        if rng_nonce is None:
            import secrets

            base_nonce = secrets.randbits(128)
            rng_nonce = lambda: (hash((base_nonce, len(nonces))) * 0x9E3779B9 + base_nonce) % R

        def record_nonce():
            v = rng_nonce() % R
            nonces.append(v)
            return v

        transition = self.interp.execute(
            program_id, function, inputs, caller=caller, rng_nonce=record_nonce
        )

        # Pass 2: circuit construction.
        cs = ConstraintSystem()
        g = Gadgets(cs)
        psd2 = PoseidonGadget(g, 2)

        # public inputs: function tag + input IDs + output IDs (computed on
        # host first — inputs must be allocated before witnesses).
        def host_plain_id(v: Value) -> int:
            return poseidon.hash_psd(2, flatten(v), domain="aleo-tpu/input-id")

        pub: List[int] = [domain_tag(f"{program_id}/{function}")]
        for decl, v in zip(fn.inputs, inputs):
            if isinstance(v, Record):
                pub.append(v.commitment())
            else:
                pub.append(host_plain_id(v))
        for v in transition.outputs:
            if isinstance(v, Record):
                pub.append(v.commitment())
            else:
                pub.append(
                    poseidon.hash_psd(2, flatten(v), domain="aleo-tpu/output-id")
                )
        tag_var = cs.alloc_input(pub[0])
        cs.enforce_eq(LC.of(tag_var), LC.constant(pub[0]))
        id_vars = [cs.alloc_input(p) for p in pub[1:]]

        # witness the inputs and bind input IDs
        regs: Dict[str, object] = {}
        counts_before = cs.num_constraints
        idx = 0
        for decl, v in zip(fn.inputs, inputs):
            cv = self._witness_value(g, v, prog)
            regs[decl.register] = cv
            if isinstance(cv, RecordCV):
                cm = self._record_commitment(g, psd2, cv)
            else:
                cm = psd2.hash(self._flatten(g, cv), domain="aleo-tpu/input-id")
            cs.enforce_eq(cm.lc, LC.of(id_vars[idx]))
            idx += 1
        counts = {"inputs": cs.num_constraints - counts_before}

        # execute instructions symbolically
        ctx = _Ctx(self, g, psd2, prog, caller, iter(nonces))
        counts_before = cs.num_constraints
        for inst in fn.instructions:
            ctx.exec_instruction(inst, regs)
        counts["body"] = cs.num_constraints - counts_before

        # bind output IDs
        counts_before = cs.num_constraints
        for o in fn.outputs:
            cv = ctx.load(regs, Operand.parse(o.register))
            if isinstance(cv, RecordCV):
                cm = self._record_commitment(g, psd2, cv)
            else:
                cm = psd2.hash(self._flatten(g, cv), domain="aleo-tpu/output-id")
            cs.enforce_eq(cm.lc, LC.of(id_vars[idx]))
            idx += 1
        counts["outputs"] = cs.num_constraints - counts_before
        counts["total"] = cs.num_constraints

        assert cs.is_satisfied(), "internal error: synthesized circuit unsatisfied"
        return Synthesis(cs, transition, cs.public_inputs(), counts)


class _Ctx:
    """Per-synthesis instruction executor (circuit twin of Interpreter)."""

    def __init__(self, syn: Synthesizer, g: Gadgets, psd2: PoseidonGadget,
                 prog: Program, caller: int, nonce_iter):
        self.syn = syn
        self.g = g
        self.psd2 = psd2
        self.prog = prog
        self.caller = caller
        self.nonce_iter = nonce_iter

    # -- operand loading -----------------------------------------------------

    def load(self, regs, op: Operand):
        g = self.g
        if op.kind == "register":
            return regs[op.value]
        if op.kind == "literal":
            v, ty = op.value
            val = literal(v, ty)
            return g.constant(val.as_field(), ty, val.data)
        if op.kind == "caller":
            return g.witness(self.caller, "address", self.caller)
        if op.kind == "member":
            reg, path = op.value
            cur = regs[reg]
            for p in path:
                if isinstance(cur, RecordCV):
                    if p == "owner":
                        cur = cur.owner
                    elif p == "gates":
                        cur = cur.gates
                    else:
                        cur = cur.entries[p]
                elif isinstance(cur, StructCV):
                    cur = cur.fields[p]
                else:
                    raise SynthesisError(f"bad member access .{p}")
            return cur
        raise SynthesisError(f"bad operand {op}")

    # -- instruction dispatch -------------------------------------------------

    def exec_instruction(self, inst: Instruction, regs):
        op = inst.opcode
        g = self.g
        ld = lambda o: self.load(regs, o)

        if op == "cast":
            self._exec_cast(inst, regs)
            return
        if op == "call":
            target_prog, target_fn = inst.call_target
            pid = target_prog or self.prog.id
            sub_prog = self.syn.registry.get(pid)
            sub_fn = sub_prog.functions.get(target_fn)
            if sub_fn is None:
                raise SynthesisError(f"unknown call target {pid}/{target_fn}")
            sub_regs: Dict[str, object] = {}
            for decl, o in zip(sub_fn.inputs, inst.operands):
                sub_regs[decl.register] = ld(o)
            sub_ctx = _Ctx(self.syn, g, self.psd2, sub_prog, self.caller, self.nonce_iter)
            for si in sub_fn.instructions:
                sub_ctx.exec_instruction(si, sub_regs)
            for dreg, o in zip(inst.dests, sub_fn.outputs):
                regs[dreg] = sub_ctx.load(sub_regs, Operand.parse(o.register))
            return
        if op in ("assert.eq", "assert.neq"):
            a, b = ld(inst.operands[0]), ld(inst.operands[1])
            eq = g.eq_scalars(self._flat(a), self._flat(b))
            if op == "assert.eq":
                g.enforce_eq(eq, g.constant(1, "boolean", True))
            else:
                g.enforce_eq(eq, g.constant(0, "boolean", False))
            return
        if op in ("is.eq", "is.neq"):
            a, b = ld(inst.operands[0]), ld(inst.operands[1])
            eq = g.eq_scalars(self._flat(a), self._flat(b))
            regs[inst.dest] = eq if op == "is.eq" else g.bool_not(eq)
            return
        if op == "ternary":
            c, a, b = (ld(o) for o in inst.operands)
            regs[inst.dest] = self._ternary(c, a, b)
            return
        if op.startswith("hash."):
            from ..reference import pedersen as ped

            kind = op.split(".", 1)[1]
            val = ld(inst.operands[0])
            if kind in ped.HASH_WIDTHS:
                bits = self._value_bit_cvs(val)
                regs[inst.dest] = self._pedersen().hash(
                    bits, f"hash.{kind}", use_bhp=kind.startswith("bhp")
                )
            else:
                rate = {"psd2": 2, "psd4": 4, "psd8": 8}.get(kind, 2)
                regs[inst.dest] = self._psd(rate).hash(
                    self._flat(val), domain=f"aleo-tpu/{op}"
                )
                regs[inst.dest].type_ = "field"
            return
        if op.startswith("commit."):
            from ..reference import pedersen as ped

            kind = op.split(".", 1)[1]
            val, rand = ld(inst.operands[0]), ld(inst.operands[1])
            if kind in ped.HASH_WIDTHS:
                bits = self._value_bit_cvs(val)
                r_bits = self._bit_cvs_of(rand, 253)
                regs[inst.dest] = self._pedersen().commit(
                    bits, r_bits, f"commit.{kind}", use_bhp=kind.startswith("bhp")
                )
            else:
                rate = {"psd2": 2, "psd4": 4, "psd8": 8}.get(kind, 2)
                regs[inst.dest] = self._psd(rate).hash(
                    self._flat(val) + [rand], domain=f"aleo-tpu/{op}"
                )
                regs[inst.dest].type_ = "field"
            return
        if op in ("gt", "gte", "lt", "lte"):
            a, b = ld(inst.operands[0]), ld(inst.operands[1])
            regs[inst.dest] = self._compare(op, a, b)
            return
        if op == "not":
            a = ld(inst.operands[0])
            if a.type_ == "boolean":
                regs[inst.dest] = g.bool_not(a)
            else:
                w = INT_WIDTHS[a.type_]
                bits = g.decompose(a, w)
                regs[inst.dest] = self._from_bits_flip(a, bits, w)
            return
        if op == "neg":
            a = ld(inst.operands[0])
            if a.type_ == "field":
                regs[inst.dest] = CV("field", LC() - a.lc, (-a.fval) % R, None)
            else:
                regs[inst.dest] = self._int_neg(a)
            return
        if op in ("square", "double", "inv"):
            a = ld(inst.operands[0])
            if op == "square":
                regs[inst.dest] = g.mul(a, a)
            elif op == "double":
                regs[inst.dest] = g.add(a, a)
            else:
                regs[inst.dest] = self._field_inv(a)
            return
        # generic binary
        a, b = ld(inst.operands[0]), ld(inst.operands[1])
        if a.type_ == "boolean" and op in ("and", "or", "xor", "nand", "nor"):
            base = {"and": g.bool_and, "or": g.bool_or, "xor": g.bool_xor}
            if op in base:
                regs[inst.dest] = base[op](a, b)
            elif op == "nand":
                regs[inst.dest] = g.bool_not(g.bool_and(a, b))
            else:
                regs[inst.dest] = g.bool_not(g.bool_or(a, b))
        elif a.type_ in INT_WIDTHS:
            regs[inst.dest] = self._int_binop(op, a, b)
        else:
            regs[inst.dest] = self._field_binop(op, a, b)

    # -- type-specific gadget families ---------------------------------------

    def _flat(self, v) -> List[CV]:
        return self.syn._flatten(self.g, v)

    def _psd(self, rate: int) -> PoseidonGadget:
        if rate == 2:
            return self.psd2
        cache = getattr(self, "_psd_cache", None)
        if cache is None:
            cache = self._psd_cache = {}
        if rate not in cache:
            cache[rate] = PoseidonGadget(self.g, rate)
        return cache[rate]

    def _pedersen(self) -> PedersenGadget:
        if getattr(self, "_ped_gadget", None) is None:
            self._ped_gadget = PedersenGadget(self.g)
        return self._ped_gadget

    def _bit_cvs_of(self, cv: CV, nbits: int) -> List[CV]:
        """Boolean-constrained bit CVs of a scalar CV (LSB first)."""
        bit_vars = self.g.decompose(cv, nbits)
        return [
            CV("boolean", LC.of(b), (cv.fval >> i) & 1, bool((cv.fval >> i) & 1))
            for i, b in enumerate(bit_vars)
        ]

    def _value_bit_cvs(self, v) -> List[CV]:
        """Circuit twin of reference.pedersen.value_bits."""
        if isinstance(v, CV) and v.type_ in INT_WIDTHS:
            return self._bit_cvs_of(v, INT_WIDTHS[v.type_])
        if isinstance(v, CV) and v.type_ == "boolean":
            return [v]
        out: List[CV] = []
        for cv in self._flat(v):
            out.extend(self._bit_cvs_of(cv, 253))
        return out

    def _ternary(self, c: CV, a, b):
        g = self.g
        if isinstance(a, StructCV):
            assert isinstance(b, StructCV) and a.type_ == b.type_
            return StructCV(
                a.type_,
                {k: self._ternary(c, a.fields[k], b.fields[k]) for k in a.fields},
            )
        if isinstance(a, RecordCV):
            raise SynthesisError("ternary over records is not supported in-circuit")
        return g.select(c, a, b)

    def _field_inv(self, a: CV) -> CV:
        g = self.g
        inv = pow(a.fval, -1, R) if a.fval else 0
        iv = g.witness(inv, "field", inv)
        g.cs.enforce(a.lc, iv.lc, LC.constant(1))
        return iv

    def _field_binop(self, op: str, a: CV, b: CV) -> CV:
        g = self.g
        if op == "add":
            return g.add(a, b)
        if op == "sub":
            return g.sub(a, b)
        if op == "mul":
            return g.mul(a, b)
        if op == "div":
            return g.mul(a, self._field_inv(b))
        if op == "pow":
            # exponent must be a compile-time constant (literal operand)
            if not isinstance(b.raw, int) or b.lc.terms not in ({}, {0: b.fval}):
                raise SynthesisError("field pow requires a literal exponent")
            e = b.raw
            acc = g.constant(1)
            base = a
            while e:
                if e & 1:
                    acc = g.mul(acc, base)
                e >>= 1
                if e:
                    base = g.mul(base, base)
            return acc
        raise SynthesisError(f"unsupported field op {op}")

    def _int_signed_lc(self, a: CV, w: int) -> Tuple[LC, int]:
        """LC and value of the signed integer (from two's complement bits)."""
        bits = self.g.decompose(a, w)
        lc = a.lc - LC.of(bits[w - 1], (1 << w))
        val = a.raw
        return lc, val

    def _int_new(self, ty: str, value: int) -> CV:
        """Allocate a range-checked integer result holding `value` (native)."""
        g = self.g
        w = INT_WIDTHS[ty]
        enc = value % (1 << w) if ty.startswith("i") else value
        cv = g.witness(enc, ty, value)
        g.decompose(cv, w)
        return cv

    def _int_neg(self, a: CV) -> CV:
        ty = a.type_
        if not ty.startswith("i"):
            raise SynthesisError("neg on unsigned integers is not satisfiable")
        w = INT_WIDTHS[ty]
        if a.raw == -(1 << (w - 1)):
            raise SynthesisError(f"{ty} negation overflow")
        out = self._int_new(ty, -a.raw)
        sa, _ = self._int_signed_lc(a, w)
        so, _ = self._int_signed_lc(out, w)
        self.g.cs.enforce_eq(sa + so, LC())
        return out

    def _compare(self, op: str, a: CV, b: CV) -> CV:
        g = self.g
        ty = a.type_
        w = INT_WIDTHS[ty]
        if ty.startswith("i"):
            # flip sign bit: unsigned comparison of offset encodings
            ab, bb = g.decompose(a, w), g.decompose(b, w)
            a_off = CV("field", a.lc - LC.of(ab[w - 1], 1 << w) + LC.constant(1 << (w - 1)),
                       (a.raw + (1 << (w - 1))) % R, None)
            b_off = CV("field", b.lc - LC.of(bb[w - 1], 1 << w) + LC.constant(1 << (w - 1)),
                       (b.raw + (1 << (w - 1))) % R, None)
            x, y, xr, yr = a_off, b_off, a.raw, b.raw
        else:
            x, y, xr, yr = a, b, a.raw, b.raw
        if op == "lt":
            out = g.unsigned_lt(x, y, w)
            out.raw = xr < yr
        elif op == "gte":
            out = g.bool_not(g.unsigned_lt(x, y, w))
            out.raw = xr >= yr
        elif op == "gt":
            out = g.unsigned_lt(y, x, w)
            out.raw = xr > yr
        else:  # lte
            out = g.bool_not(g.unsigned_lt(y, x, w))
            out.raw = xr <= yr
        return out

    def _from_bits_flip(self, a: CV, bits: List[int], w: int) -> CV:
        lc = LC()
        val = (~a.raw) & ((1 << w) - 1)
        for i, b in enumerate(bits):
            lc = lc + (LC.constant(1 << i) - LC.of(b, 1 << i))
        out = CV(a.type_, lc, val, val if a.type_.startswith("u") else
                 val - (1 << w) if val >= (1 << (w - 1)) else val)
        return out

    def _bitwise(self, op: str, a: CV, b: CV, w: int) -> CV:
        g = self.g
        ab, bb = g.decompose(a, w), g.decompose(b, w)
        lc = LC()
        for i in range(w):
            x = CV("boolean", LC.of(ab[i]), (a.fval >> i) & 1, bool((a.fval >> i) & 1))
            y = CV("boolean", LC.of(bb[i]), (b.fval >> i) & 1, bool((b.fval >> i) & 1))
            if op in ("and", "nand"):
                bit = g.bool_and(x, y)
            elif op in ("or", "nor"):
                bit = g.bool_or(x, y)
            else:
                bit = g.bool_xor(x, y)
            if op in ("nand", "nor"):
                bit = g.bool_not(bit)
            lc = lc + bit.lc.scale(1 << i)
        m = (1 << w) - 1
        xv, yv = a.fval & m, b.fval & m
        val = {"and": xv & yv, "or": xv | yv, "xor": xv ^ yv,
               "nand": ~(xv & yv) & m, "nor": ~(xv | yv) & m}[op]
        ty = a.type_
        raw = val if ty.startswith("u") else (val - (1 << w) if val >= (1 << (w - 1)) else val)
        return CV(ty, lc, val, raw)

    # -- wide/signed integer helpers (128-bit-safe gadget family) ------------

    def _int_sign_cv(self, a: CV, w: int) -> CV:
        """Sign bit of a signed integer as a boolean CV."""
        bits = self.g.decompose(a, w)
        neg = a.raw is not None and a.raw < 0
        return CV("boolean", LC.of(bits[w - 1]), int(neg), neg)

    def _int_abs(self, a: CV, w: int) -> Tuple[CV, CV]:
        """(magnitude as a field CV in [0, 2^(w-1)], sign boolean CV).

        Works for the minimum value too (|-(2^(w-1))| = 2^(w-1) is fine as a
        field magnitude even though it does not fit the signed type).
        """
        g = self.g
        sign = self._int_sign_cv(a, w)
        s_lc, s_val = self._int_signed_lc(a, w)
        pos = CV("field", s_lc, s_val % R, None)
        neg = CV("field", LC() - s_lc, (-s_val) % R, None)
        mag = g.select(sign, neg, pos, "field")
        mag.raw = abs(a.raw)
        return mag, sign

    def _split_halves(self, v: CV, w: int) -> Tuple[CV, CV]:
        """Split a w-bit-range-checked value into (lo, hi) w/2-bit halves."""
        g = self.g
        h = w // 2
        bits = g.decompose(v, w)
        lo_lc, hi_lc = LC(), LC()
        for i in range(h):
            lo_lc = lo_lc + LC.of(bits[i], 1 << i)
            hi_lc = hi_lc + LC.of(bits[h + i], 1 << i)
        fv = v.fval
        return (
            CV("field", lo_lc, fv & ((1 << h) - 1), None),
            CV("field", hi_lc, (fv >> h) & ((1 << h) - 1), None),
        )

    def _umul_checked_wide(self, x: CV, y: CV, w: int, ctx: str) -> CV:
        """x * y for w-bit magnitudes when the raw product may exceed the
        field: limb-split product constrained to be < 2^w (overflow makes
        the system unsatisfiable; honest overflow raises SynthesisError).

        Soundness: with x = xl + 2^h xh, y = yl + 2^h yh (h = w/2), the
        constraints xh*yh = 0, (xl*yh + xh*yl) < 2^h, and
        out = xl*yl + 2^h * (xl*yh + xh*yl) force out == x*y < 2^w.
        """
        g = self.g
        res = x.raw * y.raw
        if res >= (1 << w):
            raise SynthesisError(f"overflow in {ctx}")
        h = w // 2
        xl, xh = self._split_halves(x, w)
        yl, yh = self._split_halves(y, w)
        p_ll = g.mul(xl, yl)
        p_lh = g.mul(xl, yh)
        p_hl = g.mul(xh, yl)
        p_hh = g.mul(xh, yh)
        g.enforce_zero(p_hh)
        s = g.add(p_lh, p_hl)
        g.decompose(s, h)                    # forces s < 2^h
        out = CV("field", p_ll.lc + s.lc.scale(1 << h), res % R, res)
        return out

    def _umul_wrap_128(self, a: CV, b: CV, w: int) -> Tuple[LC, int]:
        """(a * b) mod 2^w on w-bit encodings when a*b may exceed the field
        (w = 128). Returns (result LC over fresh bits, result value)."""
        g = self.g
        h = w // 2
        al, ah = self._split_halves(a, w)
        bl, bh = self._split_halves(b, w)
        p_ll = g.mul(al, bl)
        p_lh = g.mul(al, bh)
        p_hl = g.mul(ah, bl)
        s = g.add(p_lh, p_hl)                # < 2^(w+1)
        s_bits = g.decompose(s, w + 1)
        s_low = LC()
        for i in range(h):
            s_low = s_low + LC.of(s_bits[i], 1 << i)
        s_low_v = s.fval % (1 << h)
        t = CV("field", p_ll.lc + s_low.scale(1 << h),
               (p_ll.fval + (s_low_v << h)) % R, None)
        t_bits = g.decompose(t, w + 1)       # t < 2^w + 2^w
        res_lc = LC()
        for i in range(w):
            res_lc = res_lc + LC.of(t_bits[i], 1 << i)
        return res_lc, t.fval % (1 << w)

    def _signed_result(self, ty: str, w: int, res_raw: int, mag: CV, sign: CV) -> CV:
        """Allocate a signed result and enforce signed(out) == +-mag."""
        g = self.g
        out = self._int_new(ty, res_raw)
        so, _ = self._int_signed_lc(out, w)
        pos = CV("field", mag.lc, mag.fval, None)
        neg = CV("field", LC() - mag.lc, (-mag.fval) % R, None)
        want = g.select(sign, neg, pos, "field")
        g.cs.enforce_eq(so, want.lc)
        return out

    def _bits_as_cvs(self, a: CV, w: int) -> List[CV]:
        bits = self.g.decompose(a, w)
        return [
            CV("boolean", LC.of(bv), (a.fval >> i) & 1, bool((a.fval >> i) & 1))
            for i, bv in enumerate(bits)
        ]

    def _shift_amount_bits(self, b: CV, w: int, wrap: bool) -> Tuple[List[CV], int]:
        """Decompose a shift-amount operand; checked mode constrains it < w.

        Returns (low log2(w) bits as boolean CVs, shift value mod w)."""
        g = self.g
        wb = INT_WIDTHS[b.type_]
        lg = w.bit_length() - 1
        bits = self._bits_as_cvs(b, wb)
        if not wrap:
            if b.raw >= w:
                raise SynthesisError("shift amount exceeds type width")
            for bit in bits[lg:]:
                g.enforce_zero(bit)
        return bits[:lg], b.raw % w

    def _barrel_shift(self, a: CV, sbits: List[CV], k: int, w: int,
                      right: bool, fill: Optional[CV]) -> CV:
        """Variable shift by sum(sbits_j * 2^j): log2(w) select stages over
        the bit vector. `fill` is the incoming bit (sign for arithmetic shr,
        else constant 0)."""
        g = self.g
        cur = self._bits_as_cvs(a, w)
        zero = g.constant(0, "boolean", False)
        fill = fill if fill is not None else zero
        for j, sb in enumerate(sbits):
            step = 1 << j
            nxt = []
            for i in range(w):
                src = i + step if right else i - step
                shifted = cur[src] if 0 <= src < w else fill if right else zero
                nxt.append(g.select(sb, shifted, cur[i], "boolean"))
            cur = nxt
        lc = LC()
        for i, bit in enumerate(cur):
            lc = lc + bit.lc.scale(1 << i)
        ty = a.type_
        kk = k
        m = (1 << w) - 1
        if right:
            # python's >> is arithmetic on signed ints, logical via fval
            val = (a.raw >> kk) % (1 << w) if fill is not zero else (a.fval >> kk) & m
        else:
            val = (a.fval << kk) & m
        raw = val if ty.startswith("u") else (val - (1 << w) if val >= (1 << (w - 1)) else val)
        return CV(ty, lc, val, raw)

    def _var_shl_checked(self, a: CV, sbits: List[CV], k: int, w: int,
                         ty: str, signed: bool, op: str) -> CV:
        """Checked shl by a register amount: a * 2^s as a checked multiply
        (2^s built from log2(w) selects of constants)."""
        g = self.g
        t = g.constant(1, "field", 1)
        for j, sb in enumerate(sbits):
            t = g.select(sb, g.scale(t, 1 << (1 << j)), t, "field")
            t.raw = t.fval
        res = a.raw << k
        if signed:
            if not (-(1 << (w - 1)) <= res < (1 << (w - 1))):
                raise SynthesisError(f"{ty} overflow in {op}")
            mag_a, sign_a = self._int_abs(a, w)
            if w > 64:
                mag = self._umul_checked_wide(mag_a, t, w, f"{ty} shl")
            else:
                mag = g.mul(mag_a, t)
                mag.raw = mag_a.raw << k
                g.decompose(mag, w)
            return self._signed_result(ty, w, res, mag, sign_a)
        if res >= (1 << w):
            raise SynthesisError(f"{ty} overflow in {op}")
        if w > 64:
            prod = self._umul_checked_wide(a, t, w, f"{ty} shl")
            out = self._int_new(ty, res)
            g.cs.enforce_eq(prod.lc, out.lc)
            return out
        out = self._int_new(ty, res)
        g.cs.enforce(a.lc, t.lc, out.lc)
        return out

    def _wrap_mul_flag(self, x: CV, y: CV, w: int) -> Tuple[CV, CV]:
        """(x * y) mod 2^w on w-bit unsigned encodings, plus an overflow
        boolean (true iff the true product >= 2^w). Both CVs are fresh."""
        g = self.g
        if w <= 64:
            prod = g.mul(x, y)
            prod.raw = x.raw * y.raw
            bits = g.decompose(prod, 2 * w)
            lo, hi = LC(), LC()
            for i in range(w):
                lo = lo + LC.of(bits[i], 1 << i)
                hi = hi + LC.of(bits[w + i], 1 << i)
            enc = prod.raw % (1 << w)
            res = CV("field", lo, enc, enc)
            hi_v = prod.raw >> w
            ovf = self.g.bool_not(
                g.is_zero(CV("field", hi, hi_v % R, hi_v))
            )
            return res, ovf
        # w = 128: limb-split wrap with overflow = (hi product != 0) or
        # (cross-sum high != 0) or carry into bit w
        h = w // 2
        xl, xh = self._split_halves(x, w)
        yl, yh = self._split_halves(y, w)
        p_ll = g.mul(xl, yl)
        p_lh = g.mul(xl, yh)
        p_hl = g.mul(xh, yl)
        p_hh = g.mul(xh, yh)
        s = g.add(p_lh, p_hl)
        s_bits = g.decompose(s, w + 1)
        s_low, s_high = LC(), LC()
        for i in range(h):
            s_low = s_low + LC.of(s_bits[i], 1 << i)
        for i in range(h, w + 1):
            s_high = s_high + LC.of(s_bits[i], 1 << (i - h))
        s_low_v = s.fval % (1 << h)
        t = CV("field", p_ll.lc + s_low.scale(1 << h),
               (p_ll.fval + (s_low_v << h)) % R, None)
        t_bits = g.decompose(t, w + 1)
        res_lc = LC()
        for i in range(w):
            res_lc = res_lc + LC.of(t_bits[i], 1 << i)
        enc = t.fval % (1 << w)
        res = CV("field", res_lc, enc, enc)
        true_prod = x.raw * y.raw
        hi_total_v = true_prod >> w
        hi_total = CV(
            "field",
            p_hh.lc + s_high + LC.of(t_bits[w]),
            hi_total_v % R, hi_total_v,
        )
        ovf = g.bool_not(g.is_zero(hi_total))
        return res, ovf

    def _var_pow(self, a: CV, b: CV, w: int, ty: str, signed: bool,
                 wrap: bool, op: str) -> CV:
        """pow with a register exponent: LSB-first square-and-multiply over
        the exponent's bits, each step a wrap-mul with an overflow flag.

        Checked mode enforces no gated step overflowed, mirroring Rust
        checked_pow (acc-muls gated on the exponent bit; base squarings
        gated on any higher bit being set). Signed bases run on
        sign-magnitude; the one legal boundary value (result exactly
        -(2^(w-1))) is admitted through the final signed-result equation.
        """
        g = self.g
        wb = INT_WIDTHS[b.type_]
        ebits = self._bits_as_cvs(b, wb)
        res_raw = a.raw ** b.raw
        if wrap:
            res_raw %= (1 << w)
            if signed and res_raw >= (1 << (w - 1)):
                res_raw -= 1 << w
        else:
            lo_ok = -(1 << (w - 1)) if signed else 0
            hi_ok = (1 << (w - 1)) if signed else (1 << w)
            if not (lo_ok <= res_raw < hi_ok):
                raise SynthesisError(f"{ty} overflow in {op}")
        if signed:
            mag_a, sign_a = self._int_abs(a, w)
            base_cv = mag_a
            # result sign: negative iff base negative and exponent odd
            sign_res = g.bool_and(sign_a, ebits[0]) if ebits else g.constant(0, "boolean", False)
        else:
            base_cv = CV("field", a.lc, a.fval, a.raw)
            base_cv.bits = a.bits
            sign_res = None
        one = g.constant(1, "field", 1)
        acc = one
        ovfs: List[CV] = []
        # suffix-nonzero gates for base squarings
        for j, ebit in enumerate(ebits):
            stepped, st_ovf = self._wrap_mul_flag(acc, base_cv, w)
            acc = g.select(ebit, stepped, acc, "field")
            acc.raw = acc.fval
            ovfs.append(g.bool_and(ebit, st_ovf))
            if j < wb - 1:
                sq, sq_ovf = self._wrap_mul_flag(base_cv, base_cv, w)
                # squaring matters iff some higher exponent bit is set
                higher = ebits[j + 1]
                for hb in ebits[j + 2 :]:
                    higher = g.bool_or(higher, hb)
                ovfs.append(g.bool_and(higher, sq_ovf))
                base_cv = sq
        if not wrap:
            for f in ovfs:
                g.enforce_zero(f)
            if signed:
                # magnitude must fit the signed range except the exact MIN,
                # which the signed-result equation admits for negatives
                msb_ok_res = res_raw if res_raw >= 0 else -res_raw
                if msb_ok_res > (1 << (w - 1)) or (
                    msb_ok_res == (1 << (w - 1)) and res_raw > 0
                ):
                    raise SynthesisError(f"{ty} overflow in {op}")
                return self._signed_result(ty, w, res_raw, acc, sign_res)
            out = self._int_new(ty, res_raw)
            g.cs.enforce_eq(acc.lc, out.lc)
            return out
        # wrapped result
        if signed:
            # wrap on sign-magnitude: res = (+-mag) mod 2^w
            enc = res_raw % (1 << w)
            out = self._int_new(ty, res_raw)
            so, _ = self._int_signed_lc(out, w)
            pos = CV("field", acc.lc, acc.fval, None)
            neg = CV("field", LC() - acc.lc, (-acc.fval) % R, None)
            want = g.select(sign_res, neg, pos, "field")
            # signed(out) == +-mag  (mod 2^w wrap folded through encoding)
            diff = so - want.lc
            # difference is a multiple of 2^w in [-2^w, 2^w]: allocate k
            kv = (int(out.raw) - (acc.fval if not sign_res.raw else -acc.fval)) >> w
            kw = g.witness(kv % R, "field", kv)
            g.cs.enforce_eq(diff, kw.lc.scale(1 << w))
            g.decompose(CV("field", kw.lc + LC.constant(1), (kv + 1) % R, None), 2)
            return out
        out = self._int_new(ty, res_raw)
        g.cs.enforce_eq(acc.lc, out.lc)
        return out

    def _int_binop(self, op: str, a: CV, b: CV) -> CV:
        g = self.g
        ty = a.type_
        w = INT_WIDTHS[ty]
        signed = ty.startswith("i")
        wrap = op.endswith(".w")
        base = op[:-2] if wrap else op

        if base in ("and", "or", "xor", "nand", "nor"):
            return self._bitwise(base, a, b, w)

        if base in ("add", "sub", "mul"):
            if signed:
                sa, _ = self._int_signed_lc(a, w)
                sb, _ = self._int_signed_lc(b, w)
                if base == "add":
                    res_lc, res = sa + sb, a.raw + b.raw
                elif base == "sub":
                    res_lc, res = sa - sb, a.raw - b.raw
                else:
                    if w > 64:
                        # i128 mul: the raw product (up to 2^254) exceeds the
                        # field, so route through sign-magnitude limb splits.
                        if wrap:
                            # mod-2^w product is sign-agnostic on encodings
                            res_lc128, enc = self._umul_wrap_128(a, b, w)
                            raw = enc - (1 << w) if enc >= (1 << (w - 1)) else enc
                            return CV(ty, res_lc128, enc, raw)
                        res = a.raw * b.raw
                        if not (-(1 << (w - 1)) <= res < (1 << (w - 1))):
                            raise SynthesisError(f"{ty} overflow in {op}")
                        mag_a, sign_a = self._int_abs(a, w)
                        mag_b, sign_b = self._int_abs(b, w)
                        mag = self._umul_checked_wide(mag_a, mag_b, w, f"{ty} mul")
                        sign = g.bool_xor(sign_a, sign_b)
                        return self._signed_result(ty, w, res, mag, sign)
                    prod = g.cs.alloc_witness((a.raw * b.raw) % R)
                    g.cs.enforce(sa, sb, LC.of(prod))
                    res_lc, res = LC.of(prod), a.raw * b.raw
                if wrap:
                    full_w = w + 1 if base in ("add", "sub") else 2 * w
                    shifted = CV("field", res_lc + LC.constant(1 << full_w),
                                 (res + (1 << full_w)) % R, None)
                    bits = g.decompose(shifted, full_w + 1)
                    out_enc = res % (1 << w)
                    lc = LC()
                    for i in range(w):
                        lc = lc + LC.of(bits[i], 1 << i)
                    raw = out_enc - (1 << w) if out_enc >= (1 << (w - 1)) else out_enc
                    return CV(ty, lc, out_enc, raw)
                res_val = res
                if not (-(1 << (w - 1)) <= res_val < (1 << (w - 1))):
                    raise SynthesisError(f"{ty} overflow in {op}")
                out = self._int_new(ty, res_val)
                so, _ = self._int_signed_lc(out, w)
                g.cs.enforce_eq(res_lc, so)
                return out
            # unsigned
            if base == "add":
                res_lc, res = a.lc + b.lc, a.raw + b.raw
                full_w = w + 1
            elif base == "sub":
                if wrap:
                    res_lc = a.lc - b.lc + LC.constant(1 << w)
                    res = a.raw - b.raw + (1 << w)
                    full_w = w + 1
                else:
                    if a.raw < b.raw:
                        raise SynthesisError(f"{ty} underflow in sub")
                    out = self._int_new(ty, a.raw - b.raw)
                    g.cs.enforce_eq(a.lc, b.lc + out.lc)
                    return out
            else:
                if w > 64:
                    # u128 mul: raw product up to 2^256 exceeds the field
                    if wrap:
                        res_lc128, enc = self._umul_wrap_128(a, b, w)
                        return CV(ty, res_lc128, enc, enc)
                    prod_f = self._umul_checked_wide(a, b, w, f"{ty} mul")
                    out = self._int_new(ty, prod_f.raw)
                    g.cs.enforce_eq(prod_f.lc, out.lc)
                    return out
                prod = g.mul(a, b)
                res_lc, res = prod.lc, a.raw * b.raw
                full_w = 2 * w
            if wrap:
                shifted = CV("field", res_lc, res % R, None)
                bits = g.decompose(shifted, full_w)
                lc = LC()
                for i in range(w):
                    lc = lc + LC.of(bits[i], 1 << i)
                return CV(ty, lc, res % (1 << w), res % (1 << w))
            if res >= (1 << w):
                raise SynthesisError(f"{ty} overflow in {op}")
            out = self._int_new(ty, res)
            g.cs.enforce_eq(res_lc, out.lc)
            return out

        if base in ("div", "rem", "mod"):
            if b.raw == 0:
                raise SynthesisError("division by zero")
            if signed:
                # truncated division: |a| = q|b| + r, r < |b|; q carries
                # sign(a) xor sign(b), r carries sign(a) (snarkVM/Rust
                # semantics). MIN / -1 overflows (host raise, like snarkVM's
                # halt).
                mag_a, sign_a = self._int_abs(a, w)
                mag_b, sign_b = self._int_abs(b, w)
                qm_v, rm_v = abs(a.raw) // abs(b.raw), abs(a.raw) % abs(b.raw)
                neg_q = (a.raw < 0) != (b.raw < 0)
                q_res = -qm_v if neg_q else qm_v
                r_res = -rm_v if a.raw < 0 else rm_v
                if base == "div" and not (-(1 << (w - 1)) <= q_res < (1 << (w - 1))):
                    raise SynthesisError(f"{ty} overflow in div")
                q_mag = g.witness(qm_v, "field", qm_v)
                r_mag = g.witness(rm_v, "field", rm_v)
                g.decompose(q_mag, w)
                g.decompose(r_mag, w)
                if w > 64:
                    # q|b| can exceed the field: limb-split checked product
                    qb = self._umul_checked_wide(q_mag, mag_b, w, "i128 div")
                else:
                    qb = g.mul(q_mag, mag_b)
                g.cs.enforce_eq(qb.lc + r_mag.lc, mag_a.lc)
                lt = g.unsigned_lt(r_mag, mag_b, w)
                g.enforce_eq(lt, g.constant(1, "boolean", True))
                sign_q = g.bool_and(
                    g.bool_xor(sign_a, sign_b), g.bool_not(g.is_zero(q_mag))
                )
                sign_r = g.bool_and(sign_a, g.bool_not(g.is_zero(r_mag)))
                if base == "div":
                    return self._signed_result(ty, w, q_res, q_mag, sign_q)
                return self._signed_result(ty, w, r_res, r_mag, sign_r)
            q, r = a.raw // b.raw, a.raw % b.raw
            qv = self._int_new(ty, q)
            rv = self._int_new(ty, r)
            # a = q*b + r  and  r < b
            if w > 64:
                qb = self._umul_checked_wide(qv, b, w, "u128 div")
            else:
                qb = g.mul(qv, b)
            g.cs.enforce_eq(a.lc, qb.lc + rv.lc)
            lt = g.unsigned_lt(rv, b, w)
            g.enforce_eq(lt, g.constant(1, "boolean", True))
            return qv if base == "div" else rv

        if base in ("shl", "shr"):
            is_lit = isinstance(b.raw, int) and b.lc.terms in ({}, {0: b.fval})
            if not is_lit:
                # register shift amount: barrel shifter over log2(w) stages;
                # checked mode constrains the amount < w, checked shl is
                # re-expressed as a checked multiply by 2^s.
                sbits, k = self._shift_amount_bits(b, w, wrap)
                if base == "shr":
                    fill = self._int_sign_cv(a, w) if signed else None
                    return self._barrel_shift(a, sbits, k, w, True, fill)
                if wrap:
                    return self._barrel_shift(a, sbits, k, w, False, None)
                return self._var_shl_checked(a, sbits, k, w, ty, signed, op)
            if not wrap and b.raw >= w:
                raise SynthesisError("shift amount exceeds type width")
            k = b.raw % w
            bits = g.decompose(a, w)
            lc = LC()
            if base == "shr":
                if signed:
                    # arithmetic shift: vacated bits copy the sign bit
                    for i in range(k, w):
                        lc = lc + LC.of(bits[i], 1 << (i - k))
                    if k:
                        fill = (1 << w) - (1 << (w - k))
                        lc = lc + LC.of(bits[w - 1], fill)
                    raw = a.raw >> k        # python >> is arithmetic
                    return CV(ty, lc, raw % (1 << w), raw)
                for i in range(k, w):
                    lc = lc + LC.of(bits[i], 1 << (i - k))
                val = (a.fval >> k)
            else:
                if signed and not wrap:
                    if not (-(1 << (w - 1)) <= (a.raw << k) < (1 << (w - 1))):
                        raise SynthesisError(f"{ty} overflow in shl")
                    sa_lc, sa_val = self._int_signed_lc(a, w)
                    out = self._int_new(ty, a.raw << k)
                    so, _ = self._int_signed_lc(out, w)
                    g.cs.enforce_eq(sa_lc.scale(1 << k), so)
                    return out
                for i in range(w - k):
                    lc = lc + LC.of(bits[i], 1 << (i + k))
                val = (a.fval << k) % (1 << w)
                if not wrap and (a.raw << k) >= (1 << w):
                    raise SynthesisError(f"{ty} overflow in shl")
                if not wrap:
                    for i in range(w - k, w):
                        g.cs.enforce_eq(LC.of(bits[i]), LC())
            raw = val if not signed else (val - (1 << w) if val >= (1 << (w - 1)) else val)
            return CV(ty, lc, val, raw)

        if base == "pow":
            is_lit = isinstance(b.raw, int) and b.lc.terms in ({}, {0: b.fval})
            if (is_lit and not signed and not wrap
                    and isinstance(b.raw, int) and 0 <= b.raw * w <= 252):
                # fast literal path: plain square-and-multiply; sound only
                # while a^e cannot wrap mod the field (e*w <= 252), so the
                # final w-bit-range equality pins the exact integer power
                res = a.raw ** b.raw
                if res >= (1 << w) or res < 0:
                    raise SynthesisError(f"{ty} overflow in pow")
                acc = g.constant(1, ty, 1)
                e = b.raw
                base_cv = a
                while e:
                    if e & 1:
                        acc = g.mul(acc, base_cv, ty)
                        acc.raw = (acc.raw if acc.raw is not None else 1)
                    e >>= 1
                    if e:
                        base_cv = g.mul(base_cv, base_cv, ty)
                out = self._int_new(ty, res)
                g.cs.enforce_eq(acc.lc, out.lc)
                return out
            return self._var_pow(a, b, w, ty, signed, wrap, op)

        raise SynthesisError(f"unsupported int op {op}")

    # -- cast -----------------------------------------------------------------

    def _exec_cast(self, inst: Instruction, regs):
        g = self.g
        ops = [self.load(regs, o) for o in inst.operands]
        ty = inst.cast_type
        if ty.endswith(".record"):
            rec_ty = ty.rsplit(".", 1)[0]
            rt = self.prog.records[rec_ty]
            assert len(ops) == len(rt.fields), "record field arity mismatch"
            owner = gates = None
            entries = {}
            for (fname, ftype, _vis), val in zip(rt.fields, ops):
                if fname == "owner":
                    owner = val
                elif fname == "gates":
                    gates = val
                else:
                    entries[fname] = val
            nonce_val = next(self.nonce_iter)
            nonce = g.witness(nonce_val, "field", nonce_val)
            if gates is None:
                gates = g.constant(0, "u64", 0)
            rec = RecordCV(self.prog.id, rec_ty, owner, gates, entries, nonce)
            regs[inst.dest] = rec
            return
        base = ty.split(".")[0]
        if base in self.prog.structs:
            st = self.prog.structs[base]
            fields = {}
            for (fname, _ftype), val in zip(st.fields, ops):
                fields[fname] = val
            regs[inst.dest] = StructCV(base, fields)
            return
        # scalar cast
        src = ops[0]
        if base == "field":
            regs[inst.dest] = CV("field", src.lc, src.fval, src.fval)
        elif base in INT_WIDTHS:
            w = INT_WIDTHS[base]
            v = src.raw if isinstance(src.raw, int) else src.fval
            out = self._int_new(base, v)
            g.cs.enforce_eq(src.lc, out.lc)
            regs[inst.dest] = out
        else:
            regs[inst.dest] = CV(base, src.lc, src.fval, src.raw)


def synthesize_execution(
    registry: Registry,
    program_id: str,
    function: str,
    inputs,
    caller: int = 0,
    rng_nonce=None,
) -> Synthesis:
    """parse -> execute -> synthesize in one call (the `Process::execute`
    circuit-synthesis twin)."""
    return Synthesizer(registry).synthesize(
        program_id, function, inputs, caller=caller, rng_nonce=rng_nonce
    )
