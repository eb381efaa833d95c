"""R1CS constraint systems, built on the host.

The synthesizer layer: the device-side analogue of snarkVM's `AleoV0` R1CS
environment (`snarkvm-circuit*`, SURVEY.md §2.8 item 7) that
`Process::execute` / `Process::synthesize_key` drive in the reference
(`upstream:wasm/src/programs/macros.rs:85-87`). Gadgets in
`aleo_tpu_torch.program.synthesizer` build circuits through this API; the Marlin
indexer/prover consume the matrices and assignments.

Constraints are (A z) o (B z) = C z with z = [inputs | witnesses], where
inputs[0] is the constant 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .. import params

R = params.R


class LinearCombination:
    """Sparse linear combination over variables: {var_index: coeff}."""

    __slots__ = ("terms",)

    def __init__(self, terms: Dict[int, int] | None = None):
        self.terms = dict(terms or {})

    @staticmethod
    def of(var: int, coeff: int = 1) -> "LinearCombination":
        return LinearCombination({var: coeff % R})

    @staticmethod
    def constant(c: int) -> "LinearCombination":
        return LinearCombination({0: c % R})

    def __add__(self, other: "LinearCombination") -> "LinearCombination":
        out = dict(self.terms)
        for v, c in other.terms.items():
            out[v] = (out.get(v, 0) + c) % R
        return LinearCombination(out)

    def __sub__(self, other: "LinearCombination") -> "LinearCombination":
        out = dict(self.terms)
        for v, c in other.terms.items():
            out[v] = (out.get(v, 0) - c) % R
        return LinearCombination(out)

    def scale(self, k: int) -> "LinearCombination":
        return LinearCombination({v: c * k % R for v, c in self.terms.items()})


LC = LinearCombination


class ConstraintSystem:
    """Collects R1CS constraints and the witness assignment."""

    def __init__(self):
        self.num_inputs = 1              # slot 0: constant one
        self.num_witnesses = 0
        self.assignments: List[int] = [1]  # public then witness, in order
        self.witness_values: List[int] = []
        self.a_rows: List[List[Tuple[int, int]]] = []
        self.b_rows: List[List[Tuple[int, int]]] = []
        self.c_rows: List[List[Tuple[int, int]]] = []

    # -- variables -----------------------------------------------------------

    @property
    def one(self) -> int:
        return 0

    def alloc_input(self, value: int) -> int:
        """Public input variable. Must be allocated before any witness."""
        assert self.num_witnesses == 0, "allocate all inputs before witnesses"
        idx = self.num_inputs
        self.num_inputs += 1
        self.assignments.append(value % R)
        return idx

    def alloc_witness(self, value: int) -> int:
        idx = self.num_inputs + self.num_witnesses
        self.num_witnesses += 1
        self.assignments.append(value % R)
        return idx

    # -- constraints ---------------------------------------------------------

    def enforce(self, a: LC, b: LC, c: LC) -> None:
        """a * b = c."""
        self.a_rows.append(sorted(a.terms.items()))
        self.b_rows.append(sorted(b.terms.items()))
        self.c_rows.append(sorted(c.terms.items()))

    def enforce_eq(self, a: LC, c: LC) -> None:
        self.enforce(a, LC.constant(1), c)

    # -- helpers with witness computation -------------------------------------

    def value(self, lc: LC) -> int:
        return sum(self.assignments[v] * c for v, c in lc.terms.items()) % R

    def mul(self, a: LC, b: LC) -> int:
        """Allocate witness for a*b and constrain it."""
        out = self.alloc_witness(self.value(a) * self.value(b) % R)
        self.enforce(a, b, LC.of(out))
        return out

    def add_vars(self, a: int, b: int) -> int:
        out = self.alloc_witness((self.assignments[a] + self.assignments[b]) % R)
        self.enforce_eq(LC.of(a) + LC.of(b), LC.of(out))
        return out

    def assert_bool(self, v: int) -> None:
        self.enforce(LC.of(v), LC.of(v) - LC.constant(1), LinearCombination())

    def inverse(self, a: int) -> int:
        inv = self.alloc_witness(pow(self.assignments[a], -1, R) if self.assignments[a] else 0)
        self.enforce(LC.of(a), LC.of(inv), LC.constant(1))
        return inv

    # -- introspection ---------------------------------------------------------

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    @property
    def num_variables(self) -> int:
        return self.num_inputs + self.num_witnesses

    def public_inputs(self) -> List[int]:
        return self.assignments[: self.num_inputs]

    def is_satisfied(self) -> bool:
        z = self.assignments

        def dot(row):
            return sum(z[v] * c for v, c in row) % R

        for ra, rb, rc in zip(self.a_rows, self.b_rows, self.c_rows):
            if dot(ra) * dot(rb) % R != dot(rc):
                return False
        return True

    def matrices(self):
        """COO triples (row, col, val) for A, B, C."""
        out = []
        for rows in (self.a_rows, self.b_rows, self.c_rows):
            coo = []
            for i, row in enumerate(rows):
                for v, c in row:
                    if c:
                        coo.append((i, v, c))
            out.append(coo)
        return out
