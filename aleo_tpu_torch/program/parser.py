"""Parser for the Aleo instructions language (the subset exercised by the
reference's example programs and credits-style transfers).

Grammar modeled on the observable syntax of the reference examples
(`upstream:examples/simple_token/main.aleo`, `token/main.aleo`,
`external_call/main.aleo`) and the snarkVM `Program` surface the reference
introspects (`upstream:wasm/src/programs/program.rs:40-423`:
functions/inputs/mappings/records/structs/imports).

Supported top-level items: program id, imports, records, structs
("interface"/"struct"), mappings, closures/functions with optional finalize
blocks. Instructions: arithmetic/logic ops, cast, call, assert, hash/commit,
mapping ops inside finalize (increment/decrement/get/get.or_init/set),
`self.caller`, register member access, typed literals.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Operand:
    kind: str          # "register" | "literal" | "caller" | "member"
    value: object      # "r0" | (text, type) | None | ("r0", ["amount"])

    @staticmethod
    def parse(tok: str) -> "Operand":
        if tok == "self.caller":
            return Operand("caller", None)
        if re.fullmatch(r"r\d+(\.\w+)+", tok):
            parts = tok.split(".")
            return Operand("member", (parts[0], parts[1:]))
        if re.fullmatch(r"r\d+", tok):
            return Operand("register", tok)
        m = re.fullmatch(r"(-?\d+)(u8|u16|u32|u64|u128|i8|i16|i32|i64|i128|field|group|scalar)", tok)
        if m:
            return Operand("literal", (int(m.group(1)), m.group(2)))
        if tok in ("true", "false"):
            return Operand("literal", (tok == "true", "boolean"))
        if tok.startswith("aleo1"):
            return Operand("literal", (tok, "address"))
        raise ValueError(f"cannot parse operand {tok!r}")


@dataclass
class Instruction:
    opcode: str
    operands: List[Operand]
    dest: Optional[str] = None
    cast_type: Optional[str] = None        # for cast
    call_target: Optional[Tuple[str, str]] = None  # (program, function)
    dests: List[str] = field(default_factory=list)
    mapping: Optional[str] = None          # for mapping ops
    key: Optional[Operand] = None


@dataclass
class IoDecl:
    register: str
    type_: str
    visibility: str       # private | public | record | constant


@dataclass
class RecordType:
    name: str
    fields: List[Tuple[str, str, str]]     # (name, type, visibility)


@dataclass
class StructType:
    name: str
    fields: List[Tuple[str, str]]


@dataclass
class Mapping:
    name: str
    key_type: str
    value_type: str


@dataclass
class FinalizeBlock:
    name: str
    inputs: List[IoDecl]
    instructions: List[Instruction]


@dataclass
class Function:
    name: str
    inputs: List[IoDecl]
    instructions: List[Instruction]
    outputs: List[IoDecl]
    finalize_operands: Optional[List[Operand]] = None


@dataclass
class Program:
    id: str
    imports: List[str]
    records: Dict[str, RecordType]
    structs: Dict[str, StructType]
    mappings: Dict[str, Mapping]
    functions: Dict[str, Function]
    finalizes: Dict[str, FinalizeBlock]
    source: str = ""

    @property
    def name(self) -> str:
        return self.id.split(".")[0]


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


BINARY_OPS = {
    "add", "sub", "mul", "div", "rem", "pow", "and", "or", "xor", "nand", "nor",
    "shl", "shr", "gt", "gte", "lt", "lte", "mod",
    "add.w", "sub.w", "mul.w",
}
TERNARY_OPS = {"ternary"}
UNARY_OPS = {"neg", "not", "abs", "square", "sqrt", "inv", "double"}
IS_OPS = {"is.eq", "is.neq"}
ASSERT_OPS = {"assert.eq", "assert.neq"}
HASH_OPS = {
    "hash.psd2", "hash.psd4", "hash.psd8", "hash.ped64", "hash.ped128",
    "hash.bhp256", "hash.bhp512", "hash.bhp768", "hash.bhp1024",
}
COMMIT_OPS = {"commit.ped64", "commit.ped128", "commit.bhp256", "commit.psd2"}


def parse_program(text: str) -> Program:
    src = text
    text = _strip_comments(text)
    # split into statements on ';' but keep block headers (lines ending with ':')
    tokens = []
    for raw in re.split(r";", text):
        raw = raw.strip()
        if raw:
            tokens.append(raw)

    prog_id = None
    imports: List[str] = []
    records: Dict[str, RecordType] = {}
    structs: Dict[str, StructType] = {}
    mappings: Dict[str, Mapping] = {}
    functions: Dict[str, Function] = {}
    finalizes: Dict[str, FinalizeBlock] = {}

    # current parse context
    ctx = None          # ("record", obj) | ("struct", obj) | ("mapping", ...) | ("function", f) | ("finalize", f)

    def close_ctx():
        pass

    i = 0
    while i < len(tokens):
        stmt = tokens[i]
        i += 1
        # A statement may contain a block header 'record token:\n  owner as ...'
        while True:
            m = re.match(
                r"(record|struct|interface|mapping|function|closure|finalize)\s+(\w+)\s*:\s*(.*)",
                stmt,
                flags=re.S,
            )
            if not m:
                break
            kind, name, rest = m.group(1), m.group(2), m.group(3)
            if kind == "record":
                ctx = ("record", RecordType(name, []))
                records[name] = ctx[1]
            elif kind in ("struct", "interface"):
                ctx = ("struct", StructType(name, []))
                structs[name] = ctx[1]
            elif kind == "mapping":
                ctx = ("mapping", Mapping(name, "", ""))
                mappings[name] = ctx[1]
            elif kind in ("function", "closure"):
                ctx = ("function", Function(name, [], [], []))
                functions[name] = ctx[1]
            else:
                ctx = ("finalize", FinalizeBlock(name, [], []))
                finalizes[name] = ctx[1]
            stmt = rest.strip()
            if not stmt:
                break
        if not stmt:
            continue

        if stmt.startswith("program "):
            prog_id = stmt.split()[1]
            continue
        if stmt.startswith("import "):
            imports.append(stmt.split()[1])
            continue

        assert ctx is not None, f"statement outside block: {stmt!r}"
        kind, obj = ctx

        if kind == "record":
            m = re.fullmatch(r"(\w+)\s+as\s+([\w.]+)", stmt)
            base, _, vis = m.group(2).partition(".")
            obj.fields.append((m.group(1), base, vis or "private"))
        elif kind == "struct":
            m = re.fullmatch(r"(\w+)\s+as\s+([\w.]+)", stmt)
            obj.fields.append((m.group(1), m.group(2)))
        elif kind == "mapping":
            m = re.fullmatch(r"(key|value)\s+(\w+)\s+as\s+([\w.]+)", stmt)
            ty = m.group(3).split(".")[0]
            if m.group(1) == "key":
                obj.key_type = ty
            else:
                obj.value_type = ty
        else:
            inst = _parse_statement(stmt, obj, kind)
            if inst is not None:
                obj.instructions.append(inst)

    assert prog_id, "missing program id"
    return Program(prog_id, imports, records, structs, mappings, functions, finalizes, src)


def _parse_statement(stmt: str, obj, kind: str):
    words = stmt.split()
    op = words[0]

    if op == "input":
        m = re.fullmatch(r"input\s+(r\d+)\s+as\s+([\w./]+)", stmt)
        tyfull = m.group(2)
        if tyfull.endswith(".record") or "/" in tyfull:
            base = tyfull.rsplit(".", 1)[0]
            vis = "record"
        else:
            base, _, vis = tyfull.partition(".")
            vis = vis or "private"
        obj.inputs.append(IoDecl(m.group(1), base, vis))
        return None
    if op == "output":
        m = re.fullmatch(r"output\s+(\S+)\s+as\s+([\w./]+)", stmt)
        tyfull = m.group(2)
        if tyfull.endswith(".record"):
            base, vis = tyfull.rsplit(".", 1)[0], "record"
        else:
            base, _, vis = tyfull.partition(".")
            vis = vis or "private"
        obj.outputs.append(IoDecl(m.group(1), base, vis))
        return None
    if op == "finalize" and kind == "function":
        obj.finalize_operands = [Operand.parse(w) for w in words[1:]]
        return None

    if op == "cast":
        m = re.fullmatch(r"cast\s+(.+?)\s+into\s+(r\d+)\s+as\s+([\w./]+)", stmt)
        ops = [Operand.parse(w) for w in m.group(1).split()]
        return Instruction("cast", ops, dest=m.group(2), cast_type=m.group(3))
    if op == "call":
        m = re.fullmatch(r"call\s+(\S+)\s+(.*?)\s*into\s+(.+)", stmt)
        target = m.group(1)
        prog, _, fn = target.partition("/")
        if not fn:
            prog, fn = None, target
        ops = [Operand.parse(w) for w in m.group(2).split()] if m.group(2) else []
        dests = m.group(3).split()
        return Instruction("call", ops, call_target=(prog, fn), dests=dests)
    if op in ASSERT_OPS:
        ops = [Operand.parse(w) for w in words[1:]]
        return Instruction(op, ops)
    if op in ("increment", "decrement"):
        m = re.fullmatch(r"(increment|decrement)\s+(\w+)\[(\S+)\]\s+by\s+(\S+)", stmt)
        return Instruction(
            m.group(1),
            [Operand.parse(m.group(4))],
            mapping=m.group(2),
            key=Operand.parse(m.group(3)),
        )
    if op in ("get", "get.or_init"):
        if op == "get.or_init":
            m = re.fullmatch(r"get\.or_init\s+(\w+)\[(\S+)\]\s+(\S+)\s+into\s+(r\d+)", stmt)
            return Instruction(
                "get.or_init",
                [Operand.parse(m.group(3))],
                dest=m.group(4),
                mapping=m.group(1),
                key=Operand.parse(m.group(2)),
            )
        m = re.fullmatch(r"get\s+(\w+)\[(\S+)\]\s+into\s+(r\d+)", stmt)
        return Instruction("get", [], dest=m.group(3), mapping=m.group(1), key=Operand.parse(m.group(2)))
    if op == "set":
        m = re.fullmatch(r"set\s+(\S+)\s+into\s+(\w+)\[(\S+)\]", stmt)
        return Instruction(
            "set", [Operand.parse(m.group(1))], mapping=m.group(2), key=Operand.parse(m.group(3))
        )

    # generic "<op> <operands> into <dest>" instructions
    m = re.fullmatch(r"([\w.]+)\s+(.*?)\s+into\s+(r\d+)", stmt)
    if m:
        opc = m.group(1)
        ops = [Operand.parse(w) for w in m.group(2).split()]
        return Instruction(opc, ops, dest=m.group(3))
    raise ValueError(f"cannot parse instruction: {stmt!r}")
