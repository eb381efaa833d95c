"""Seeded credits.aleo transitions, as a proving service receives them.

Each transition spends one record of the caller's (its own owner, amount and
nonce) or, for `transfer_public`, moves a public balance; each has its own
receiver and amount, and the nonces its new records get. Everything is drawn
from (seed, step, slot), so a step's inputs are the same in every run of a
seed and differ between steps and slots. Every draw is a value of the same
width (field elements, u64 amounts), so the circuit's work is the same for
every seed.
"""

from __future__ import annotations

import random
from typing import Dict, List

from ..reference.field import R


def transition(seed: int, step: int, slot: int, traffic: Dict) -> Dict:
    rng = random.Random(f"credits/{seed}/{step}/{slot}")
    lo, hi = traffic["microcredits"]
    mc = rng.randrange(lo, hi)
    return {
        "owner": rng.randrange(1, R),
        "microcredits": mc,
        "nonce": rng.randrange(R),
        "receiver": rng.randrange(1, R),
        "amount": rng.randrange(1, mc),
        "out_nonces": [rng.randrange(R) for _ in range(traffic.get("new_records", 0))],
    }


def transitions(seed: int, step: int, k: int, traffic: Dict) -> List[Dict]:
    return [transition(seed, step, slot, traffic) for slot in range(k)]
