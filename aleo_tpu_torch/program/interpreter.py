"""Aleo program interpreter (host execution + finalize semantics).

Capability twin of snarkVM's `Process::execute` evaluation half and the
finalize engine behind mapping updates (reference call stack: SURVEY.md
§3.1; `aleo run` local execution at `upstream:cli/commands/run.rs`).
Executes functions over the value model, producing output values, created
records, and finalize operations; `run_finalize` applies a finalize block
against a mapping store (the dev-ledger state).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import params
from ..reference import poseidon
from .parser import Function, Instruction, Operand, Program
from .values import INT_WIDTHS, Record, Value, domain_tag, flatten, literal

R = params.R


class ExecutionError(Exception):
    pass


@dataclass
class Registry:
    """Program registry for import/call resolution."""

    programs: Dict[str, Program] = field(default_factory=dict)

    def add(self, prog: Program):
        self.programs[prog.id] = prog

    def get(self, pid: str) -> Program:
        if pid not in self.programs:
            raise ExecutionError(f"unknown program {pid}")
        return self.programs[pid]


@dataclass
class Transition:
    program: str
    function: str
    inputs: List[object]
    outputs: List[object]
    consumed_records: List[Record]
    created_records: List[Record]
    finalize_args: Optional[List[Value]]


def _int_binop(op: str, a: Value, b: Value) -> Value:
    ty = a.type_
    w = INT_WIDTHS[ty]
    signed = ty.startswith("i")
    lo = -(1 << (w - 1)) if signed else 0
    hi = (1 << (w - 1)) if signed else (1 << w)
    x, y = a.data, b.data
    wrap = op.endswith(".w")
    base = op[:-2] if wrap else op
    if base == "add":
        v = x + y
    elif base == "sub":
        v = x - y
    elif base == "mul":
        v = x * y
    elif base in ("div", "rem"):
        if y == 0:
            raise ExecutionError("division by zero")
        # truncated toward zero (exact bigint math — float division loses
        # precision at 128 bits)
        q = abs(x) // abs(y)
        if (x < 0) != (y < 0):
            q = -q
        v = q if base == "div" else x - y * q
    elif base == "pow":
        v = x**y
    elif base in ("shl", "shr"):
        if wrap:
            k = y % w
        elif y >= w:
            raise ExecutionError("shift amount exceeds type width")
        else:
            k = y
        v = (x << k) if base == "shl" else (x >> k)
    elif base in ("and", "or", "xor", "nand", "nor"):
        m = (1 << w) - 1
        xv, yv = x & m, y & m
        v = {"and": xv & yv, "or": xv | yv, "xor": xv ^ yv,
             "nand": ~(xv & yv) & m, "nor": ~(xv | yv) & m}[base]
    elif base == "mod":
        v = x % y
    else:
        raise ExecutionError(f"unsupported int op {op}")
    if wrap:
        m = (1 << w) - 1
        v &= m
        if signed and v >= (1 << (w - 1)):
            v -= 1 << w
    elif not (lo <= v < hi):
        raise ExecutionError(f"{ty} overflow in {op}: {v}")
    return Value(ty, v)


def _field_binop(op: str, a: Value, b: Value) -> Value:
    x, y = a.as_field(), b.as_field()
    if op == "add":
        return Value("field", (x + y) % R)
    if op == "sub":
        return Value("field", (x - y) % R)
    if op == "mul":
        return Value("field", x * y % R)
    if op == "div":
        return Value("field", x * pow(y, -1, R) % R)
    if op == "pow":
        return Value("field", pow(x, y, R))
    raise ExecutionError(f"unsupported field op {op}")


class Interpreter:
    def __init__(self, registry: Registry):
        self.registry = registry

    def execute(
        self,
        program_id: str,
        function: str,
        inputs: List[Value | Record],
        caller: int = 0,
        rng_nonce=None,
    ) -> Transition:
        prog = self.registry.get(program_id)
        fn = prog.functions.get(function)
        if fn is None:
            raise ExecutionError(f"unknown function {program_id}/{function}")
        if len(inputs) != len(fn.inputs):
            raise ExecutionError("input arity mismatch")

        regs: Dict[str, object] = {}
        consumed, created = [], []
        for decl, val in zip(fn.inputs, inputs):
            if decl.visibility == "record":
                assert isinstance(val, Record), f"{decl.register} expects a record"
                consumed.append(val)
            regs[decl.register] = val

        for inst in fn.instructions:
            self._exec_instruction(prog, inst, regs, caller, created, consumed, rng_nonce)

        outputs = [self._load(regs, Operand.parse(o.register), caller) for o in fn.outputs]
        fin = None
        if fn.finalize_operands is not None:
            fin = [self._to_value(self._load(regs, op, caller)) for op in fn.finalize_operands]
        return Transition(
            program=program_id,
            function=function,
            inputs=inputs,
            outputs=outputs,
            consumed_records=consumed,
            created_records=created,
            finalize_args=fin,
        )

    # -- helpers --------------------------------------------------------------

    def _load(self, regs, op: Operand, caller: int):
        if op.kind == "register":
            return regs[op.value]
        if op.kind == "literal":
            v, ty = op.value
            return literal(v, ty)
        if op.kind == "caller":
            return Value("address", caller)
        if op.kind == "member":
            reg, path = op.value
            cur = regs[reg]
            for p in path:
                if isinstance(cur, Record):
                    if p == "owner":
                        cur = Value("address", cur.owner)
                    elif p == "gates":
                        cur = Value("u64", cur.gates)
                    else:
                        cur = cur.entries[p]
                elif isinstance(cur, Value) and isinstance(cur.data, dict):
                    cur = cur.data[p]
                else:
                    raise ExecutionError(f"bad member access .{p}")
            return cur
        raise ExecutionError(f"bad operand {op}")

    @staticmethod
    def _to_value(v) -> Value:
        assert isinstance(v, Value), "record cannot be a finalize operand"
        return v

    def _exec_instruction(self, prog, inst: Instruction, regs, caller, created, consumed, rng_nonce):
        op = inst.opcode
        ld = lambda o: self._load(regs, o, caller)

        if op == "cast":
            self._exec_cast(prog, inst, regs, caller, created, rng_nonce)
            return
        if op == "call":
            target_prog, target_fn = inst.call_target
            pid = target_prog or prog.id
            sub = self.execute(pid, target_fn, [ld(o) for o in inst.operands], caller, rng_nonce)
            created.extend(sub.created_records)
            consumed.extend(sub.consumed_records)
            for dreg, val in zip(inst.dests, sub.outputs):
                regs[dreg] = val
            return
        if op in ("assert.eq", "assert.neq"):
            a, b = ld(inst.operands[0]), ld(inst.operands[1])
            eq = flatten(self._to_value(a)) == flatten(self._to_value(b))
            if op == "assert.eq" and not eq:
                raise ExecutionError("assert.eq failed")
            if op == "assert.neq" and eq:
                raise ExecutionError("assert.neq failed")
            return
        if op in ("is.eq", "is.neq"):
            a, b = ld(inst.operands[0]), ld(inst.operands[1])
            eq = flatten(self._to_value(a)) == flatten(self._to_value(b))
            regs[inst.dest] = Value("boolean", eq if op == "is.eq" else not eq)
            return
        if op == "ternary":
            c, a, b = (ld(o) for o in inst.operands)
            regs[inst.dest] = a if c.data else b
            return
        if op.startswith("hash."):
            from ..reference import pedersen

            kind = op.split(".", 1)[1]
            val = self._to_value(ld(inst.operands[0]))
            if kind in pedersen.HASH_WIDTHS:
                out = pedersen.hash_instruction(kind, val)
            else:
                rate = {"psd2": 2, "psd4": 4, "psd8": 8}.get(kind, 2)
                out = poseidon.hash_psd(rate, flatten(val), domain=f"aleo-tpu/{op}")
            regs[inst.dest] = Value("field", out)
            return
        if op.startswith("commit."):
            from ..reference import pedersen

            kind = op.split(".", 1)[1]
            val = self._to_value(ld(inst.operands[0]))
            rand = self._to_value(ld(inst.operands[1]))
            if kind in pedersen.HASH_WIDTHS:
                out = pedersen.commit_instruction(kind, val, rand.as_field())
            else:
                rate = {"psd2": 2, "psd4": 4, "psd8": 8}.get(kind, 2)
                out = poseidon.hash_psd(
                    rate, flatten(val) + [rand.as_field()], domain=f"aleo-tpu/{op}"
                )
            regs[inst.dest] = Value("field", out)
            return
        if op in ("gt", "gte", "lt", "lte"):
            a, b = ld(inst.operands[0]), ld(inst.operands[1])
            x, y = a.data, b.data
            res = {"gt": x > y, "gte": x >= y, "lt": x < y, "lte": x <= y}[op]
            regs[inst.dest] = Value("boolean", res)
            return
        if op == "not":
            a = ld(inst.operands[0])
            if a.type_ == "boolean":
                regs[inst.dest] = Value("boolean", not a.data)
            else:
                w = INT_WIDTHS[a.type_]
                regs[inst.dest] = Value(a.type_, ~a.data & ((1 << w) - 1))
            return
        if op == "neg":
            a = ld(inst.operands[0])
            if a.type_ == "field":
                regs[inst.dest] = Value("field", (-a.data) % R)
            else:
                regs[inst.dest] = Value(a.type_, -a.data)
            return
        if op in ("square", "double", "inv"):
            a = self._to_value(ld(inst.operands[0]))
            x = a.as_field()
            out = {"square": x * x % R, "double": 2 * x % R,
                   "inv": pow(x, -1, R) if x else 0}[op]
            regs[inst.dest] = Value("field", out)
            return
        # generic binary
        a, b = ld(inst.operands[0]), ld(inst.operands[1])
        a, b = self._to_value(a), self._to_value(b)
        if a.type_ == "boolean" and op in ("and", "or", "xor", "nand", "nor"):
            x, y = bool(a.data), bool(b.data)
            res = {"and": x and y, "or": x or y, "xor": x != y,
                   "nand": not (x and y), "nor": not (x or y)}[op]
            regs[inst.dest] = Value("boolean", res)
        elif a.type_ in INT_WIDTHS:
            regs[inst.dest] = _int_binop(op, a, b)
        else:
            regs[inst.dest] = _field_binop(op, a, b)

    def _exec_cast(self, prog, inst, regs, caller, created, rng_nonce):
        ops = [self._load(regs, o, caller) for o in inst.operands]
        ty = inst.cast_type
        if ty.endswith(".record"):
            rec_ty = ty.rsplit(".", 1)[0]
            rt = prog.records[rec_ty]
            assert len(ops) == len(rt.fields), "record field arity mismatch"
            owner = gates = None
            entries = {}
            for (fname, ftype, _vis), val in zip(rt.fields, ops):
                val = self._to_value(val)
                if fname == "owner":
                    owner = val.as_field()
                elif fname == "gates":
                    gates = val.as_int()
                else:
                    entries[fname] = val
            nonce = (
                rng_nonce() if rng_nonce else secrets.randbits(250) % R
            )
            rec = Record(prog.id, rec_ty, owner, gates or 0, entries, nonce)
            regs[inst.dest] = rec
            created.append(rec)
            return
        base = ty.split(".")[0]
        if base in prog.structs:
            st = prog.structs[base]
            data = {}
            for (fname, _ftype), val in zip(st.fields, ops):
                data[fname] = self._to_value(val)
            regs[inst.dest] = Value(base, data)
            return
        # scalar cast
        regs[inst.dest] = Value(base, self._to_value(ops[0]).as_field() if base == "field" else ops[0].data)


# ---------------------------------------------------------------------------
# Finalize execution against a mapping store.
# ---------------------------------------------------------------------------


class MappingStore:
    """In-memory program mapping state: (program, mapping) -> {key_fe: Value}."""

    def __init__(self):
        self.data: Dict[Tuple[str, str], Dict[int, Value]] = {}

    def get(self, prog: str, mapping: str, key: int) -> Optional[Value]:
        return self.data.get((prog, mapping), {}).get(key)

    def set(self, prog: str, mapping: str, key: int, value: Value):
        self.data.setdefault((prog, mapping), {})[key] = value

    def snapshot(self):
        import copy

        return copy.deepcopy(self.data)

    def restore(self, snap):
        self.data = snap


def run_finalize(prog: Program, name: str, args: List[Value], store: MappingStore, caller: int = 0):
    """Execute a finalize block; raises ExecutionError to signal revert."""
    fb = prog.finalizes.get(name)
    if fb is None:
        return
    interp = Interpreter(Registry())
    regs: Dict[str, object] = {}
    assert len(args) == len(fb.inputs)
    for decl, val in zip(fb.inputs, args):
        regs[decl.register] = val
    snap = store.snapshot()
    try:
        for inst in fb.instructions:
            op = inst.opcode
            ld = lambda o: interp._load(regs, o, caller)
            if op in ("increment", "decrement"):
                key = interp._to_value(ld(inst.key)).as_field()
                amt = interp._to_value(ld(inst.operands[0]))
                cur = store.get(prog.id, inst.mapping, key)
                cur_v = cur.data if cur else 0
                delta = amt.data if op == "increment" else -amt.data
                nv = Value(amt.type_, cur_v + delta)
                store.set(prog.id, inst.mapping, key, nv)
            elif op == "get.or_init":
                key = interp._to_value(ld(inst.key)).as_field()
                cur = store.get(prog.id, inst.mapping, key)
                regs[inst.dest] = cur if cur is not None else interp._to_value(ld(inst.operands[0]))
            elif op == "get":
                key = interp._to_value(ld(inst.key)).as_field()
                cur = store.get(prog.id, inst.mapping, key)
                if cur is None:
                    raise ExecutionError(f"missing key in {inst.mapping}")
                regs[inst.dest] = cur
            elif op == "set":
                key = interp._to_value(ld(inst.key)).as_field()
                store.set(prog.id, inst.mapping, key, interp._to_value(ld(inst.operands[0])))
            else:
                interp._exec_instruction(prog, inst, regs, caller, [], [], None)
    except ExecutionError:
        store.restore(snap)
        raise
