"""Runtime value model for Aleo programs (host side).

Typed values mirroring snarkVM's console types as observed through the
reference's wasm surface (`upstream:wasm/src/record/*`,
`wasm/src/programs/program.rs` member types): integers u8..u128/i8..i128,
field, scalar, group, boolean, address, structs, records.

Every plaintext value flattens deterministically to a list of Fr elements
(`flatten`) — the encoding used for Poseidon hashing/commitments both on
host and in-circuit.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List

from .. import params
from ..reference import poseidon

R = params.R

INT_WIDTHS = {
    "u8": 8, "u16": 16, "u32": 32, "u64": 64, "u128": 128,
    "i8": 8, "i16": 16, "i32": 32, "i64": 64, "i128": 128,
}


@dataclass
class Value:
    type_: str                   # "u64" | "field" | "boolean" | "address" | struct/record name
    data: object                 # int | bool | dict | Record

    def __post_init__(self):
        if self.type_ in INT_WIDTHS:
            w = INT_WIDTHS[self.type_]
            v = int(self.data)
            if self.type_.startswith("u"):
                assert 0 <= v < (1 << w), f"{self.type_} out of range: {v}"
            else:
                assert -(1 << (w - 1)) <= v < (1 << (w - 1))
            self.data = v

    # -- conversions ---------------------------------------------------------

    def as_int(self) -> int:
        if self.type_ == "boolean":
            return int(bool(self.data))
        return int(self.data)

    def as_field(self) -> int:
        """Canonical Fr encoding of a scalar-like value."""
        if self.type_ in INT_WIDTHS:
            w = INT_WIDTHS[self.type_]
            v = self.data
            return v % (1 << w) if self.type_.startswith("i") else v
        if self.type_ in ("field", "scalar", "group", "address"):
            return int(self.data) % R
        if self.type_ == "boolean":
            return int(bool(self.data))
        raise TypeError(f"not scalar-like: {self.type_}")


@dataclass
class Record:
    program: str
    type_: str
    owner: int                   # address as Fr element
    gates: int
    entries: Dict[str, Value]
    nonce: int                   # Fr element

    def commitment(self) -> int:
        flat = [domain_tag(self.program), domain_tag(self.type_), self.owner, self.gates]
        for name, v in self.entries.items():
            flat.extend(flatten(v))
        flat.append(self.nonce)
        return poseidon.hash_psd(2, flat, domain="aleo-tpu/record-commit")

    def serial_number(self, sk: int) -> int:
        return poseidon.hash_psd(2, [sk, self.commitment()], domain="aleo-tpu/serial")


def domain_tag(s: str) -> int:
    return int.from_bytes(s.encode()[:31], "little") % R


def flatten(v: Value) -> List[int]:
    """Deterministic Fr encoding of a plaintext value."""
    if isinstance(v.data, dict):  # struct
        out = [domain_tag(v.type_)]
        for name in sorted(v.data):
            out.extend(flatten(v.data[name]))
        return out
    return [v.as_field()]


def literal(value, type_: str) -> Value:
    if type_ == "address" and isinstance(value, str):
        from ..sdk.account import address_to_field

        return Value("address", address_to_field(value))
    return Value(type_, value)
