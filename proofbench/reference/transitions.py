"""The public inputs of a credits.aleo transition, worked out from its inputs.

A transition circuit binds [1, the function's domain tag, one ID per input,
one ID per output]. A record's ID is its commitment, a rate-2 Poseidon hash
in the domain "aleo-tpu/record-commit" of [tag(program), tag(record type),
owner, gates, its entries, nonce]; another value's is the rate-2 hash of the
value in "aleo-tpu/input-id" or "aleo-tpu/output-id". The outputs follow
snarkVM's credits.aleo: `transfer_private` makes the receiver's record and
then the sender's change, each with the next nonce of the transition;
`transfer_public` outputs nothing (its finalize moves public balances).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .field import R
from .poseidon import hash_psd

PROGRAM = "credits.aleo"
RECORD = "credits"


def tag(s: str) -> int:
    return int.from_bytes(s.encode()[:31], "little") % R


def record_id(owner: int, microcredits: int, nonce: int, gates: int = 0) -> int:
    flat = [tag(PROGRAM), tag(RECORD), owner % R, gates, microcredits, nonce % R]
    return hash_psd(2, flat, domain="aleo-tpu/record-commit")


def value_id(v: int, domain: str) -> int:
    return hash_psd(2, [v % R], domain=domain)


def _transfer_private(t: Dict) -> List[int]:
    mc, amount, (n_recv, n_change) = t["microcredits"], t["amount"], t["out_nonces"]
    assert 0 <= amount <= mc < 1 << 64
    return [record_id(t["owner"], mc, t["nonce"]),
            value_id(t["receiver"], "aleo-tpu/input-id"),
            value_id(amount, "aleo-tpu/input-id"),
            record_id(t["receiver"], amount, n_recv),
            record_id(t["owner"], mc - amount, n_change)]


def _transfer_public(t: Dict) -> List[int]:
    return [value_id(t["receiver"], "aleo-tpu/input-id"),
            value_id(t["amount"], "aleo-tpu/input-id")]


IDS: Dict[str, Callable[[Dict], List[int]]] = {
    "transfer_private": _transfer_private,
    "transfer_public": _transfer_public,
}


def public_inputs(function: str, transition: Dict) -> List[int]:
    """transition: the benchmark's description of one execution (owner,
    microcredits, nonce of the spent record; receiver, amount; the nonces
    the execution hands its new records)."""
    return [1, tag(f"{PROGRAM}/{function}")] + IDS[function](transition)
