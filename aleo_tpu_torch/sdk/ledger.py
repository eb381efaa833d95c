"""In-process development ledger (the local snarkOS devnet role).

The reference's tests run against a single-beacon snarkOS dev chain
(`.circleci/config.yml:163-200`); the SDK needs no network, so its
layers (API client, ProgramManager, RecordFinder, dev server, CLI) run
against this in-process chain instead. It maintains blocks, deployed
programs, record commitments/ciphertexts, spent serial numbers, and the
finalize mapping store, and optionally verifies transition proofs on
`add_transaction` (`verify_proofs=False` is the `Package::run`-style dev
mode — execution validated by re-running the interpreter, no SNARK).

Validation rejects a serial number that a transaction consumes twice, across
its transitions (the fee's included), besides one already spent on chain.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import params
from ..program.interpreter import Interpreter, MappingStore, Registry, run_finalize
from ..program.parser import parse_program
from ..program.values import Record, Value
from ..reference import poseidon
from ..utils import profiling as prof
from . import account as acct
from .credits import CREDITS_PROGRAM
from .merkle import MerkleTree, verify_path
from .transactions import RecordCiphertext, Transaction, TransitionData

R = params.R


class LedgerError(Exception):
    pass


@dataclass
class Block:
    height: int
    previous_hash: str
    transactions: List[Transaction]
    hash: str = ""

    def compute_hash(self) -> str:
        h = hashlib.sha256()
        h.update(self.previous_hash.encode())
        h.update(self.height.to_bytes(8, "little"))
        for tx in self.transactions:
            h.update(tx.digest().encode())
        return "ab1" + h.hexdigest()


class Ledger:
    """Single-node chain state + validation."""

    def __init__(self, verify_proofs: bool = False):
        self.verify_proofs = verify_proofs
        self.registry = Registry()
        self.registry.add(parse_program(CREDITS_PROGRAM))
        self.program_sources: Dict[str, str] = {"credits.aleo": CREDITS_PROGRAM}
        self.blocks: List[Block] = []
        self.mappings = MappingStore()
        self.record_ciphertexts: Dict[int, RecordCiphertext] = {}  # commitment ->
        self.commitment_height: Dict[int, int] = {}
        self.spent_serials: Dict[int, str] = {}   # serial -> transition id
        self.transactions: Dict[str, Transaction] = {}
        self.transition_index: Dict[str, str] = {}  # transition id -> tx id
        self.mempool: List[Transaction] = []
        self.function_vks: Dict[str, object] = {}   # "prog/fn" -> VerifyingKey
        # commitment state tree (the Trace::prepare state-path backend)
        self.commitment_tree = MerkleTree()
        self.commitment_index: Dict[int, int] = {}  # commitment -> leaf idx
        self.known_roots = {self.commitment_tree.root()}
        genesis = Block(0, "ab1" + "0" * 64, [])
        genesis.hash = genesis.compute_hash()
        self.blocks.append(genesis)

    # -- chain queries (the node REST surface) -------------------------------

    @property
    def latest_height(self) -> int:
        return self.blocks[-1].height

    @property
    def latest_hash(self) -> str:
        return self.blocks[-1].hash

    def get_block(self, height: int) -> Block:
        if not 0 <= height <= self.latest_height:
            raise LedgerError(f"no block at height {height}")
        return self.blocks[height]

    def get_block_by_hash(self, block_hash: str) -> Block:
        for blk in self.blocks:
            if blk.hash == block_hash:
                return blk
        raise LedgerError(f"no block with hash {block_hash}")

    def state_root(self) -> str:
        payload = f"{self.latest_hash}/{self.commitment_tree.root()}"
        return "sr1" + hashlib.sha256(payload.encode()).hexdigest()

    def get_state_path(self, commitment: int):
        """(tree_root, merkle path) for a record commitment — the node's
        state-path endpoint behind `Trace::prepare(Query)` (SURVEY §3.1)."""
        idx = self.commitment_index.get(commitment)
        if idx is None:
            raise LedgerError(f"commitment {commitment} not on chain")
        return self.commitment_tree.root(), self.commitment_tree.prove(idx)

    def get_program(self, program_id: str) -> str:
        if program_id not in self.program_sources:
            raise LedgerError(f"program {program_id} not deployed")
        return self.program_sources[program_id]

    def get_mapping_value(self, program_id: str, mapping: str, key) -> Optional[Value]:
        key_f = key if isinstance(key, int) else Value("address", key).as_field()
        return self.mappings.get(program_id, mapping, key_f)

    # -- devnet bootstrap ----------------------------------------------------

    def genesis_mint(self, address: str, microcredits: int, n_records: int = 1):
        """Mint credits records to an address (beacon genesis role)."""
        addr_x = acct.address_to_field(address)
        recs = []
        for i in range(n_records):
            nonce = poseidon.hash_psd(
                2, [self.latest_height, addr_x, i], domain="aleo-tpu/genesis-nonce"
            )
            rec = Record(
                "credits.aleo", "credits", addr_x, 0,
                {"microcredits": Value("u64", microcredits // n_records)}, nonce,
            )
            recs.append(rec)
        tx = Transaction(id=Transaction.fresh_id("execute"), kind="execute")
        from .transactions import Execution

        tds = []
        for rec in recs:
            td = TransitionData(
                id=TransitionData.fresh_id(),
                program_id="credits.aleo",
                function="mint",
                public_inputs=[],
                serial_numbers=[],
                output_commitments=[rec.commitment()],
                output_ciphertexts=[RecordCiphertext.encrypt(rec)],
                finalize_args=None,
                proof=None,
            )
            tds.append(td)
        tx.execution = Execution(tds)
        self._apply_transaction(tx)
        self._seal_block([tx])
        return recs

    # -- validation + application -------------------------------------------

    def add_transaction(self, tx: Transaction) -> str:
        """Validate, apply, and seal a transaction into a new block.
        Returns the transaction id (the broadcast response)."""
        self._validate(tx)
        self._apply_transaction(tx)
        self._seal_block([tx])
        return tx.id

    def _validate(self, tx: Transaction):
        if tx.id in self.transactions:
            raise LedgerError("duplicate transaction id")
        if tx.kind == "execute" and not tx.transitions():
            raise LedgerError("execute transaction carries no transitions")
        if tx.kind == "deploy":
            d = tx.deployment
            if d.program_id in self.program_sources:
                raise LedgerError(f"program {d.program_id} already deployed")
            prog = parse_program(d.program_source)
            if prog.id != d.program_id:
                raise LedgerError("program id mismatch")
            for imp in prog.imports:
                if imp not in self.program_sources:
                    raise LedgerError(f"import {imp} not deployed")
        consumed = set()
        for t in tx.transitions():
            for sn in t.serial_numbers:
                if sn in self.spent_serials:
                    raise LedgerError(f"record already spent (serial {sn})")
                if sn in consumed:
                    raise LedgerError(f"record spent twice in one transaction (serial {sn})")
                consumed.add(sn)
            if t.program_id != "credits.aleo" or t.function != "mint":
                if t.program_id not in self.program_sources and tx.kind != "deploy":
                    raise LedgerError(f"program {t.program_id} not deployed")
            if self.verify_proofs and t.proof is not None:
                self._verify_transition_proof(t)
            elif self.verify_proofs and t.proof is None:
                raise LedgerError("proof required")
            # inclusion proofs for consumed records (Trace::prepare twin):
            # each (commitment, root, path) must verify against a historical
            # state-tree root
            for (cm, root, path) in (t.inclusion_proofs or []):
                if root not in self.known_roots:
                    raise LedgerError("inclusion proof against unknown root")
                if not verify_path(root, cm, path):
                    raise LedgerError(f"invalid inclusion proof for {cm}")

    def _verify_transition_proof(self, t: TransitionData):
        from ..snark.serialize import proof_from_bytes
        from ..snark.verifier import verify

        key = f"{t.program_id}/{t.function}"
        vk = self.function_vks.get(key)
        if vk is None:
            raise LedgerError(f"no verifying key registered for {key}")
        proof, _, _, _ = proof_from_bytes(t.proof)
        with prof.stage("ledger/verify"):
            ok = verify(vk, t.public_inputs, proof)
        if not ok:
            raise LedgerError(f"invalid proof for transition {t.id}")

    def _apply_transaction(self, tx: Transaction):
        if tx.kind == "deploy":
            d = tx.deployment
            self.program_sources[d.program_id] = d.program_source
            self.registry.add(parse_program(d.program_source))
        snapshot = self.mappings.snapshot()
        try:
            for t in tx.transitions():
                if t.finalize_args is not None:
                    prog = self.registry.get(t.program_id)
                    run_finalize(prog, t.function, t.finalize_args, self.mappings)
        except Exception:
            self.mappings.restore(snapshot)
            raise
        height = self.latest_height + 1
        for t in tx.transitions():
            for sn in t.serial_numbers:
                self.spent_serials[sn] = t.id
            for ct in t.output_ciphertexts:
                self.record_ciphertexts[ct.commitment] = ct
                self.commitment_height[ct.commitment] = height
                self.commitment_index[ct.commitment] = self.commitment_tree.append(
                    ct.commitment
                )
            self.transition_index[t.id] = tx.id
        self.transactions[tx.id] = tx

    def _seal_block(self, txs: List[Transaction]):
        blk = Block(self.latest_height + 1, self.latest_hash, txs)
        blk.hash = blk.compute_hash()
        self.blocks.append(blk)
        self.known_roots.add(self.commitment_tree.root())

    # -- record scanning (RecordFinder backend) ------------------------------

    def records_in_range(self, start: int, end: int) -> List[RecordCiphertext]:
        out = []
        for cm, h in self.commitment_height.items():
            if start <= h <= end:
                out.append(self.record_ciphertexts[cm])
        return out

    def is_spent(self, serial: int) -> bool:
        return serial in self.spent_serials
