"""RecordFinder — unspent-record discovery with amount constraints.

Capability twin of `upstream:rust/src/program/helpers/records.rs:21-77`:
finds records to fund transfer amounts and fees, via the API client's
view-key scan (`get_unspent_records`, blocking.rs:229-325).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..program.values import Record
from . import account as acct


class RecordFinderError(Exception):
    pass


class RecordFinder:
    def __init__(self, api_client):
        self.api_client = api_client

    def find_amount_and_fee_records(
        self, amount: int, fee: int, private_key: acct.PrivateKey
    ) -> Tuple[Record, Record]:
        """Two distinct records covering (amount, fee) — records.rs:35-43."""
        recs = self.find_record_amounts([amount, fee], private_key)
        if len(recs) < 2:
            raise RecordFinderError("insufficient distinct records for amount + fee")
        return recs[0], recs[1]

    def find_one_record(
        self, private_key: acct.PrivateKey, amount: int
    ) -> Record:
        """One record with at least `amount` microcredits — records.rs:47-53."""
        found = self.api_client.get_unspent_records(
            private_key, specified_amounts=[amount]
        )
        for _cm, rec in found:
            if rec.entries["microcredits"].data >= amount:
                return rec
        raise RecordFinderError(
            f"no unspent record with >= {amount} microcredits found"
        )

    def find_record_amounts(
        self, amounts: List[int], private_key: acct.PrivateKey
    ) -> List[Record]:
        """Distinct records covering each requested amount — records.rs:59-65."""
        found = self.api_client.get_unspent_records(private_key)
        found = sorted(found, key=lambda t: -t[1].entries["microcredits"].data)
        out: List[Record] = []
        used = set()
        for amount in sorted(amounts, reverse=True):
            for cm, rec in found:
                if cm in used:
                    continue
                if rec.entries["microcredits"].data >= amount:
                    out.append(rec)
                    used.add(cm)
                    break
            else:
                raise RecordFinderError(
                    f"no unspent record with >= {amount} microcredits"
                )
        return out

    def find_unspent_records_on_chain(
        self, private_key: acct.PrivateKey, max_microcredits: Optional[int] = None
    ) -> List[Record]:
        return [
            rec
            for _cm, rec in self.api_client.get_unspent_records(
                private_key, max_microcredits=max_microcredits
            )
        ]
