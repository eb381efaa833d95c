"""AleoAPIClient — the node REST client surface.

Capability twin of `upstream:rust/src/api/blocking.rs:23-356`
(19 endpoints + the view-key record scan), with two backends:

  * `LocalAPIClient` — an in-process `Ledger` (the local devnet role the
    reference's CI bootstraps via snarkOS).
  * `HttpAPIClient` — urllib against a running dev server / node exposing
    the same REST paths (`/testnet3/...`).

Method names and semantics mirror the reference client 1:1 so ProgramManager
and RecordFinder are backend-agnostic.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional, Tuple

from ..curves.edwards_device import shared_secrets
from ..fields import limbs
from ..program.values import Record
from . import account as acct
from .ledger import Block, Ledger, LedgerError
from .transactions import RecordCiphertext, Transaction

MAX_BLOCK_RANGE = 50  # reference: get_blocks caps at 50 per request
BATCH_ECDH_MIN = 64   # device batch threshold for the view-key scan (the reference's)


def _batch_shared(view_key: acct.ViewKey, cts, device):
    """ECDH shared points for a ciphertext batch on `device`
    (curves/edwards_device, one ladder for the batch) from BATCH_ECDH_MIN
    ciphertexts on; below that, None for each, and each record's probe takes
    its host ECDH. BATCH_ECDH_MIN is the reference's size rule, kept as it
    is: it was not set from times on a GPU. `chip_smoke.py scan_widths`
    times both paths by width; where they cross is in PERF.md."""
    if len(cts) < BATCH_ECDH_MIN:
        return [None] * len(cts)
    return shared_secrets(view_key.scalar, [ct.eph for ct in cts], device=device)


class ApiError(Exception):
    pass


class LocalAPIClient:
    """Blocking client over an in-process ledger (`AleoAPIClient` twin).
    `device` (None: CUDA, raising without it) runs the batched ECDH of the
    record scans."""

    def __init__(self, ledger: Ledger, network: str = "testnet3", device=None):
        self.ledger = ledger
        self.network = network
        self.device = limbs.resolve_device(device)

    # -- chain state (blocking.rs:23-72) -------------------------------------

    def latest_height(self) -> int:
        return self.ledger.latest_height

    def latest_hash(self) -> str:
        return self.ledger.latest_hash

    def latest_block(self) -> Block:
        return self.ledger.blocks[-1]

    def get_block(self, height: int) -> Block:
        try:
            return self.ledger.get_block(height)
        except LedgerError as e:
            raise ApiError(str(e)) from e

    def get_block_by_hash(self, block_hash: str) -> Block:
        try:
            return self.ledger.get_block_by_hash(block_hash)
        except LedgerError as e:
            raise ApiError(str(e)) from e

    def get_blocks(self, start: int, end: int) -> List[Block]:
        if end - start > MAX_BLOCK_RANGE:
            raise ApiError(
                f"cannot request more than {MAX_BLOCK_RANGE} blocks per call"
            )
        return [self.get_block(h) for h in range(start, min(end, self.latest_height() + 1))]

    def get_state_root(self) -> str:
        return self.ledger.state_root()

    def get_state_path(self, commitment: int):
        """Inclusion proof for a record commitment (Trace::prepare's query)."""
        try:
            return self.ledger.get_state_path(commitment)
        except LedgerError as e:
            raise ApiError(str(e)) from e

    # -- transactions (blocking.rs:76-91, 328-356) ---------------------------

    def get_transaction(self, tx_id: str) -> Transaction:
        tx = self.ledger.transactions.get(tx_id)
        if tx is None:
            raise ApiError(f"transaction {tx_id} not found")
        return tx

    def get_memory_pool_transactions(self) -> List[Transaction]:
        return list(self.ledger.mempool)

    def transaction_broadcast(self, tx: Transaction) -> str:
        try:
            return self.ledger.add_transaction(tx)
        except LedgerError as e:
            raise ApiError(f"transaction rejected: {e}") from e

    # -- programs (blocking.rs:94-160) ---------------------------------------

    def get_program(self, program_id: str) -> str:
        try:
            return self.ledger.get_program(program_id)
        except LedgerError as e:
            raise ApiError(str(e)) from e

    def get_program_imports(self, program_id: str) -> Dict[str, str]:
        """DFS import resolution (blocking.rs:106-128)."""
        from ..program.parser import parse_program

        found: Dict[str, str] = {}

        def visit(pid: str):
            src = self.get_program(pid)
            prog = parse_program(src)
            for imp in prog.imports:
                if imp not in found:
                    visit(imp)
                    found[imp] = self.get_program(imp)

        visit(program_id)
        return found

    def get_program_mappings(self, program_id: str) -> List[str]:
        from ..program.parser import parse_program

        return list(parse_program(self.get_program(program_id)).mappings)

    def get_mapping_value(self, program_id: str, mapping: str, key):
        v = self.ledger.get_mapping_value(program_id, mapping, key)
        return None if v is None else v.data

    # -- search (blocking.rs:163-178) ----------------------------------------

    def find_block_hash(self, tx_id: str) -> Optional[str]:
        for blk in self.ledger.blocks:
            if any(tx.id == tx_id for tx in blk.transactions):
                return blk.hash
        return None

    def find_transition_id(self, serial_number: int) -> Optional[str]:
        return self.ledger.spent_serials.get(serial_number)

    def _records_in_range(self, start: int, end: int) -> List[RecordCiphertext]:
        return self.ledger.records_in_range(start, end)

    def _scan_registry(self):
        return self.ledger.registry

    # -- record scanning (blocking.rs:181-325) -------------------------------

    def scan(
        self,
        view_key: acct.ViewKey,
        start_height: int,
        end_height: int,
        max_records: Optional[int] = None,
    ) -> List[RecordCiphertext]:
        """All record ciphertexts owned by the view key in a height range."""
        if end_height > self.latest_height() + 1:
            end_height = self.latest_height() + 1
        cts = self._records_in_range(start_height, end_height)
        shared = _batch_shared(view_key, cts, self.device)
        out = []
        for ct, sh in zip(cts, shared):
            if ct.is_owner(view_key, sh):
                out.append(ct)
                if max_records and len(out) >= max_records:
                    break
        return out

    def get_unspent_records(
        self,
        private_key: acct.PrivateKey,
        start_height: int = 0,
        end_height: Optional[int] = None,
        max_microcredits: Optional[int] = None,
        specified_amounts: Optional[List[int]] = None,
    ) -> List[Tuple[int, Record]]:
        """Reverse scan for unspent credits records (blocking.rs:229-325):
        ownership probe, serial-number spent check, then decryption. Returns
        [(commitment, record)] sorted by microcredits descending."""
        view_key = private_key.view_key()
        sk = view_key.scalar
        end = end_height if end_height is not None else self.latest_height() + 1
        found: List[Tuple[int, Record]] = []
        total = 0
        remaining = sorted(specified_amounts, reverse=True) if specified_amounts else None
        step = MAX_BLOCK_RANGE - 1
        hi = end
        while hi > start_height:
            lo = max(start_height, hi - step)
            cts = [
                ct
                for ct in self._records_in_range(lo, hi)
                if ct.program == "credits.aleo" and ct.type_ == "credits"
            ]
            shared_pts = _batch_shared(view_key, cts, self.device)
            for ct, sh in zip(cts, shared_pts):
                if not ct.is_owner(view_key, sh):
                    continue
                rec = ct.decrypt(view_key, self._scan_registry(), sh)
                serial = rec.serial_number(sk)
                if self.find_transition_id(serial) is not None:
                    continue  # spent
                found.append((ct.commitment, rec))
                amt = rec.entries["microcredits"].data
                total += amt
                if max_microcredits and total >= max_microcredits:
                    return found
                if remaining:
                    if amt >= remaining[0]:
                        remaining.pop(0)
                    if not remaining:
                        return found
            hi = lo
        found.sort(key=lambda t: -t[1].entries["microcredits"].data)
        return found


class HttpAPIClient(LocalAPIClient):
    """urllib twin of the blocking `ureq` client against a REST node/dev
    server exposing the same paths (`DevServer.handle_node_get`). Full
    19-endpoint surface: chain state, blocks, transactions, programs/
    mappings, search, state paths, broadcast — plus the inherited view-key
    scan and `get_unspent_records`, which run client-side over HTTP-fetched
    blocks (`sdk/src/aleo_network_client.ts:270-427` behavior)."""

    def __init__(self, base_url: str, network: str = "testnet3", device=None):
        self.base_url = base_url.rstrip("/")
        self.network = network
        self.device = limbs.resolve_device(device)
        self._registry_cache = None

    @staticmethod
    def _read(resp_or_err):
        try:
            body = json.loads(resp_or_err.read())
        except Exception:
            body = None
        if isinstance(body, dict) and "error" in body:
            raise ApiError(body["error"])
        return body

    def _get(self, path: str):
        url = f"{self.base_url}/{self.network}/{path}"
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                return self._read(resp)
        except urllib.error.HTTPError as e:
            self._read(e)
            raise ApiError(f"GET {path}: HTTP {e.code}") from e

    def _post(self, path: str, body) -> object:
        url = f"{self.base_url}/{self.network}/{path}"
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return self._read(resp)
        except urllib.error.HTTPError as e:
            self._read(e)
            raise ApiError(f"POST {path}: HTTP {e.code}") from e

    # -- chain state ---------------------------------------------------------

    def latest_height(self) -> int:
        return int(self._get("latest/height"))

    def latest_hash(self) -> str:
        return self._get("latest/hash")

    def latest_block(self) -> Block:
        from . import wire

        return wire.block_from_json(self._get("latest/block"))

    def get_block(self, height: int) -> Block:
        from . import wire

        return wire.block_from_json(self._get(f"block/{height}"))

    def get_block_by_hash(self, block_hash: str) -> Block:
        from . import wire

        return wire.block_from_json(self._get(f"block/{block_hash}"))

    def get_blocks(self, start: int, end: int) -> List[Block]:
        from . import wire

        if end - start > MAX_BLOCK_RANGE:
            raise ApiError(
                f"cannot request more than {MAX_BLOCK_RANGE} blocks per call"
            )
        return [
            wire.block_from_json(b)
            for b in self._get(f"blocks?start={start}&end={end}")
        ]

    def get_state_root(self) -> str:
        return self._get("latest/stateRoot")

    def get_state_path(self, commitment: int):
        d = self._get(f"statePath/{commitment}")
        return int(d["root"]), [(int(s), bool(side)) for s, side in d["path"]]

    # -- transactions --------------------------------------------------------

    def get_transaction(self, tx_id: str) -> Transaction:
        from . import wire

        return wire.transaction_from_json(self._get(f"transaction/{tx_id}"))

    def get_memory_pool_transactions(self) -> List[Transaction]:
        from . import wire

        return [
            wire.transaction_from_json(t)
            for t in self._get("memoryPool/transactions")
        ]

    def transaction_broadcast(self, tx) -> str:
        from . import wire

        body = tx if isinstance(tx, dict) else wire.transaction_to_json(tx)
        return self._post("transaction/broadcast", body)

    # -- programs ------------------------------------------------------------

    def get_program(self, program_id: str) -> str:
        return self._get(f"program/{program_id}")

    def get_program_mappings(self, program_id: str) -> List[str]:
        return list(self._get(f"program/{program_id}/mappings"))

    def get_mapping_value(self, program_id: str, mapping: str, key):
        key_f = key if isinstance(key, int) else acct.address_to_field(key)
        v = self._get(f"program/{program_id}/mapping/{mapping}/{key_f}")
        return None if v is None else int(v)

    # -- search --------------------------------------------------------------

    def find_block_hash(self, tx_id: str) -> Optional[str]:
        return self._get(f"find/blockHash/{tx_id}")

    def find_transition_id(self, serial_number: int) -> Optional[str]:
        return self._get(f"find/transitionID/{serial_number}")

    # -- scan plumbing (client-side over fetched blocks) ---------------------

    def _records_in_range(self, start: int, end: int) -> List[RecordCiphertext]:
        out: List[RecordCiphertext] = []
        h = start
        while h < end:
            hi = min(end, h + MAX_BLOCK_RANGE)
            for blk in self.get_blocks(h, hi):
                for tx in blk.transactions:
                    for tr in tx.transitions():
                        out.extend(tr.output_ciphertexts)
            h = hi
        return out

    def _scan_registry(self):
        """Program registry for record decryption, built from fetched
        sources (credits.aleo plus any program seen in scanned records)."""
        from ..program.parser import parse_program
        from .ledger import CREDITS_PROGRAM
        from ..program.interpreter import Registry

        if self._registry_cache is None:
            reg = Registry()
            reg.add(parse_program(CREDITS_PROGRAM))
            self._registry_cache = reg
        return self._registry_cache
