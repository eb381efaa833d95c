"""JSON wire codecs for the chain types served over the node REST surface.

The reference's node API returns blocks/transactions as JSON and the JS/Rust
clients parse them back into typed models
(`upstream:sdk/src/models/*.ts`, `rust/src/api/blocking.rs:41-91`).
These codecs are that wire format for this framework's own chain types: big
integers as decimal strings (JSON numbers lose precision past 2^53), points
as [x, y] pairs, proofs as hex.
"""

from __future__ import annotations

from typing import Optional

from ..program.values import Value
from .transactions import (
    Authorization,
    Deployment,
    Execution,
    RecordCiphertext,
    Transaction,
    TransitionData,
)


def _i(v) -> str:
    return str(int(v))


def value_to_json(v: Value) -> dict:
    return {"type": v.type_, "value": str(v.data)}


def value_from_json(d: dict) -> Value:
    ty, raw = d["type"], d["value"]
    if ty == "boolean":
        return Value(ty, raw in (True, "True", "true", "1"))
    return Value(ty, int(raw))


def record_ct_to_json(ct: RecordCiphertext) -> dict:
    return {
        "program": ct.program,
        "type": ct.type_,
        "eph": [_i(ct.eph[0]), _i(ct.eph[1])],
        "ct": [_i(v) for v in ct.ct],
        "commitment": _i(ct.commitment),
    }


def record_ct_from_json(d: dict) -> RecordCiphertext:
    return RecordCiphertext(
        program=d["program"],
        type_=d["type"],
        eph=(int(d["eph"][0]), int(d["eph"][1])),
        ct=[int(v) for v in d["ct"]],
        commitment=int(d["commitment"]),
    )


def transition_to_json(t: TransitionData) -> dict:
    return {
        "id": t.id,
        "program": t.program_id,
        "function": t.function,
        "public_inputs": [_i(v) for v in t.public_inputs],
        "serial_numbers": [_i(v) for v in t.serial_numbers],
        "output_commitments": [_i(v) for v in t.output_commitments],
        "output_ciphertexts": [record_ct_to_json(ct) for ct in t.output_ciphertexts],
        "finalize_args": (
            None if t.finalize_args is None
            else [value_to_json(v) for v in t.finalize_args]
        ),
        "proof": t.proof.hex() if t.proof else None,
        "inclusion_proofs": (
            None if t.inclusion_proofs is None
            else [
                [_i(cm), _i(root), [[_i(s), int(side)] for (s, side) in path]]
                for (cm, root, path) in t.inclusion_proofs
            ]
        ),
    }


def transition_from_json(d: dict) -> TransitionData:
    return TransitionData(
        id=d["id"],
        program_id=d["program"],
        function=d["function"],
        public_inputs=[int(v) for v in d["public_inputs"]],
        serial_numbers=[int(v) for v in d["serial_numbers"]],
        output_commitments=[int(v) for v in d["output_commitments"]],
        output_ciphertexts=[record_ct_from_json(c) for c in d["output_ciphertexts"]],
        finalize_args=(
            None if d.get("finalize_args") is None
            else [value_from_json(v) for v in d["finalize_args"]]
        ),
        proof=bytes.fromhex(d["proof"]) if d.get("proof") else None,
        inclusion_proofs=(
            None if d.get("inclusion_proofs") is None
            else [
                (int(cm), int(root), [(int(s), bool(side)) for s, side in path])
                for cm, root, path in d["inclusion_proofs"]
            ]
        ),
    )


def authorization_to_json(a: Optional[Authorization]) -> Optional[dict]:
    if a is None:
        return None
    return {
        "program": a.program_id,
        "function": a.function,
        "input_ids": [_i(v) for v in a.input_ids],
        "caller": a.caller,
        "signature": [_i(a.signature[0]), _i(a.signature[1])],
    }


def authorization_from_json(d: Optional[dict]) -> Optional[Authorization]:
    if d is None:
        return None
    return Authorization(
        program_id=d["program"],
        function=d["function"],
        input_ids=[int(v) for v in d["input_ids"]],
        caller=d["caller"],
        signature=(int(d["signature"][0]), int(d["signature"][1])),
    )


def transaction_to_json(tx: Transaction) -> dict:
    out = {"id": tx.id, "type": tx.kind, "fee": tx.fee}
    if tx.execution:
        out["execution"] = {
            "transitions": [transition_to_json(t) for t in tx.execution.transitions],
            "authorization": authorization_to_json(tx.execution.authorization),
        }
    if tx.deployment:
        d = tx.deployment
        out["deployment"] = {
            "program_id": d.program_id,
            "program": d.program_source,
            "verifying_key_ids": d.verifying_key_ids,
            "owner": d.owner,
            "signature": (
                None if d.signature is None
                else [_i(d.signature[0]), _i(d.signature[1])]
            ),
        }
    if tx.fee_transition:
        out["fee_transition"] = transition_to_json(tx.fee_transition)
    return out


def transaction_from_json(d: dict) -> Transaction:
    execution = None
    if d.get("execution"):
        execution = Execution(
            transitions=[
                transition_from_json(t) for t in d["execution"]["transitions"]
            ],
            authorization=authorization_from_json(
                d["execution"].get("authorization")
            ),
        )
    deployment = None
    if d.get("deployment"):
        dd = d["deployment"]
        deployment = Deployment(
            program_id=dd["program_id"],
            program_source=dd["program"],
            verifying_key_ids=dict(dd["verifying_key_ids"]),
            owner=dd["owner"],
            signature=(
                None if dd.get("signature") is None
                else (int(dd["signature"][0]), int(dd["signature"][1]))
            ),
        )
    return Transaction(
        id=d["id"],
        kind=d["type"],
        execution=execution,
        deployment=deployment,
        fee_transition=(
            transition_from_json(d["fee_transition"])
            if d.get("fee_transition") else None
        ),
        fee=int(d.get("fee", 0)),
    )


def block_to_json(blk) -> dict:
    return {
        "height": blk.height,
        "previous_hash": blk.previous_hash,
        "hash": blk.hash,
        "transactions": [transaction_to_json(tx) for tx in blk.transactions],
    }


def block_from_json(d: dict):
    from .ledger import Block

    blk = Block(
        height=int(d["height"]),
        previous_hash=d["previous_hash"],
        transactions=[transaction_from_json(t) for t in d["transactions"]],
        hash=d["hash"],
    )
    return blk
