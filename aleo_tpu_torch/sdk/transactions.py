"""Transaction / transition assembly, authorization, and fee accounting.

Capability twin of the reference's transaction layer:
  * `Authorization` — a signed execution request over the input IDs
    (`VM::authorize` in SURVEY.md §3.1; Schnorr over Edwards-BLS12 via
    `sdk.account`).
  * `Transaction::from_execution` / `from_deployment` assembly
    (`upstream:wasm/src/programs/manager/execute.rs:188`,
    `deploy.rs:122-129`).
  * `execution_cost` / `deployment_cost` fee estimation re-exported by the
    reference at `rust/src/lib.rs:227-229`, and the namespace fee
    10^(10-len) credits (`rust/src/program/deploy.rs:161-169`).
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import params
from ..program.values import Record, Value, domain_tag, flatten
from ..reference import poseidon
from . import account as acct

R = params.R

# fee model (microcredits): per-constraint proving cost + per-byte storage
CONSTRAINT_FEE = 25          # microcredits per R1CS constraint
STORAGE_BYTE_FEE = 100       # microcredits per serialized byte
FINALIZE_OP_FEE = 2_500      # microcredits per finalize instruction


@dataclass
class Authorization:
    """A signed execution request: binds (program, function, input IDs) to
    the caller's address before any proving happens."""

    program_id: str
    function: str
    input_ids: List[int]
    caller: str                  # aleo1... address
    signature: tuple             # (challenge, response)

    @staticmethod
    def sign(private_key: acct.PrivateKey, program_id: str, function: str,
             input_ids: List[int]) -> "Authorization":
        msg = [domain_tag(f"{program_id}/{function}")] + list(input_ids)
        sig = private_key.sign(msg)
        return Authorization(
            program_id, function, list(input_ids),
            private_key.address().to_string(), sig,
        )

    def verify(self) -> bool:
        msg = [domain_tag(f"{self.program_id}/{self.function}")] + list(self.input_ids)
        return acct.verify(acct.Address.from_string(self.caller), msg, self.signature)


@dataclass
class TransitionData:
    """One proven (or dev-mode unproven) transition inside a transaction."""

    id: str
    program_id: str
    function: str
    public_inputs: List[int]          # tag + input IDs + output IDs
    serial_numbers: List[int]         # consumed record serials
    output_commitments: List[int]
    output_ciphertexts: List["RecordCiphertext"]  # one per created record
    finalize_args: Optional[List]     # host Values for the finalize block
    proof: Optional[bytes]            # serialized SNARK proof (None = dev mode)
    inclusion_proofs: Optional[List] = None  # [(commitment, root, merkle path)]
                                      # for consumed records (Trace::prepare)

    @staticmethod
    def fresh_id() -> str:
        return "au1" + secrets.token_hex(16)


@dataclass
class Execution:
    transitions: List[TransitionData]
    authorization: Optional[Authorization] = None


@dataclass
class Deployment:
    program_id: str
    program_source: str
    verifying_key_ids: Dict[str, str]   # function -> vk digest (hex)
    owner: str                          # aleo1... address
    signature: Optional[tuple] = None   # ProgramOwner signature over the id


@dataclass
class Transaction:
    """`Transaction::from_execution` / `from_deployment` twin."""

    id: str
    kind: str                     # "execute" | "deploy"
    execution: Optional[Execution] = None
    deployment: Optional[Deployment] = None
    fee_transition: Optional[TransitionData] = None
    fee: int = 0                  # microcredits

    @staticmethod
    def fresh_id(kind: str) -> str:
        return ("at1" if kind == "execute" else "ad1") + secrets.token_hex(16)

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(self.id.encode())
        for t in self.transitions():
            h.update(t.id.encode())
            for p in t.public_inputs:
                h.update(int(p).to_bytes(32, "little"))
        return h.hexdigest()

    def transitions(self) -> List[TransitionData]:
        out = list(self.execution.transitions) if self.execution else []
        if self.fee_transition:
            out.append(self.fee_transition)
        return out


# ---------------------------------------------------------------------------
# fees (execution_cost / deployment_cost twins)
# ---------------------------------------------------------------------------


def execution_cost(num_constraints: int, num_finalize_ops: int,
                   size_bytes: int) -> int:
    """Microcredits for an execution: proving + storage + finalize."""
    return (
        num_constraints * CONSTRAINT_FEE
        + size_bytes * STORAGE_BYTE_FEE // 10
        + num_finalize_ops * FINALIZE_OP_FEE
    )


def deployment_cost(total_constraints: int, program_bytes: int) -> int:
    """Microcredits for a deployment: key synthesis + program storage."""
    return total_constraints * CONSTRAINT_FEE * 4 + program_bytes * STORAGE_BYTE_FEE


def namespace_cost(program_id: str) -> int:
    """10^(10 - name_len) credits for short names (deploy.rs:161-169)."""
    name = program_id.split(".")[0]
    if len(name) >= 10:
        return 0
    return 10 ** (10 - len(name)) * 1_000_000


# ---------------------------------------------------------------------------
# record ciphertexts (owner-encrypted record payloads)
# ---------------------------------------------------------------------------


@dataclass
class RecordCiphertext:
    """Owner-encrypted record (the reference's `RecordCiphertext`,
    `upstream:wasm/src/record/record_ciphertext.rs:35-65`): program/
    type metadata and the commitment are public; owner, gates, entries, and
    nonce are an ECDH+Poseidon stream ciphertext under the owner address."""

    program: str
    type_: str
    eph: tuple                   # ephemeral Edwards point
    ct: List[int]                # enc([owner, gates, *entry fields, nonce])
    commitment: int

    @staticmethod
    def encrypt(rec: Record) -> "RecordCiphertext":
        addr = acct.Address.from_string(acct.field_to_address(rec.owner))
        fields = [rec.owner, rec.gates]
        for name in rec.entries:
            fields.extend(flatten(rec.entries[name]))
        fields.append(rec.nonce)
        eph, ct = acct.encrypt_fields(addr, fields)
        return RecordCiphertext(rec.program, rec.type_, eph, ct, rec.commitment())

    def is_owner(self, view_key: acct.ViewKey, shared=None) -> bool:
        """Ownership probe: decrypt only the first field and compare to the
        view key's address x-coordinate (the reference's
        `is_owner_with_address_x_coordinate`, blocking.rs:275). `shared`
        takes the precomputed ECDH point from the device batch scan."""
        owner = acct.decrypt_fields(view_key, self.eph, self.ct[:1], shared)[0]
        return owner == view_key.address().x % R

    def decrypt(self, view_key: acct.ViewKey, registry, shared=None) -> Record:
        """Full decrypt; needs the record schema from the program registry.
        Entry values must be literals (struct entries unsupported)."""
        fields = acct.decrypt_fields(view_key, self.eph, self.ct, shared)
        prog = registry.get(self.program)
        rtype = prog.records[self.type_]
        owner, gates = fields[0], fields[1]
        entries: Dict[str, Value] = {}
        i = 2
        for (name, base, _vis) in rtype.fields:
            if name in ("owner", "gates"):
                continue
            entries[name] = Value(base, fields[i] if base != "boolean" else bool(fields[i]))
            i += 1
        nonce = fields[i]
        rec = Record(self.program, self.type_, owner, gates, entries, nonce)
        if rec.commitment() != self.commitment:
            raise ValueError("record ciphertext does not match commitment")
        return rec
