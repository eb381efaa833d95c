"""ProgramManager — execute/deploy/transfer orchestration.

Capability twin of the reference's central orchestration object
(`upstream:rust/src/program/mod.rs:45-150`) and its flows:

  * `execute_program` (`rust/src/program/execute.rs:94-178`): resolve the
    program + imports from the chain, authorize (sign the input IDs —
    `VM::authorize`'s role in SURVEY.md §3.1), interpret + synthesize the
    circuit, prove (or dev-mode: skip the SNARK, `Package::run` style),
    attach a `credits.aleo/fee` transition, assemble and broadcast.
  * `deploy_program` (`deploy.rs:21-143`): on-chain import/state checks,
    per-function key synthesis, deployment + namespace fees, owner
    signature, broadcast.
  * `transfer` (`transfer.rs:23-110`): the 4 transfer kinds with the
    reference's input shapes.
  * key management: plaintext private key XOR encrypted ciphertext+password
    (`mod.rs:129-150` conflict rules).
"""

from __future__ import annotations

import hashlib
from enum import Enum
from typing import Dict, List, Optional

from ..fields import limbs
from ..program.interpreter import Interpreter, Registry
from ..program.parser import parse_program
from ..program.values import Record, Value, domain_tag, flatten
from ..reference import poseidon
from . import account as acct
from . import encryptor
from .records import RecordFinder
from .transactions import (
    Authorization,
    Deployment,
    Execution,
    RecordCiphertext,
    Transaction,
    TransitionData,
    deployment_cost,
    execution_cost,
    namespace_cost,
)


class ProgramManagerError(Exception):
    pass


class OnChainProgramState(Enum):
    """network.rs:40-51."""

    Same = "same"
    Different = "different"
    NotDeployed = "not_deployed"


class TransferType(Enum):
    """helpers/mod.rs:30-39."""

    Private = "transfer_private"
    PrivateToPublic = "transfer_private_to_public"
    Public = "transfer_public"
    PublicToPrivate = "transfer_public_to_private"


def _plain_input_id(v: Value) -> int:
    """Host twin of the synthesizer's public input-ID derivation
    (program/synthesizer.py host_plain_id)."""
    return poseidon.hash_psd(2, flatten(v), domain="aleo-tpu/input-id")


def _plain_output_id(v: Value) -> int:
    return poseidon.hash_psd(2, flatten(v), domain="aleo-tpu/output-id")


class ProgramManager:
    def __init__(
        self,
        api_client,
        private_key: Optional[acct.PrivateKey] = None,
        private_key_ciphertext: Optional[encryptor.PrivateKeyCiphertext] = None,
        device=None,
    ):
        """`device` (None: CUDA, raising without it) holds the function keys
        and runs the proofs."""
        # key XOR ciphertext rule (mod.rs:57-70)
        if (private_key is None) == (private_key_ciphertext is None):
            raise ProgramManagerError(
                "exactly one of private_key / private_key_ciphertext required"
            )
        self.api_client = api_client
        self.device = limbs.resolve_device(device)
        self.private_key = private_key
        self.private_key_ciphertext = private_key_ciphertext
        self.registry = Registry()
        self.record_finder = RecordFinder(api_client)
        self._key_cache: Dict[str, object] = {}   # "prog/fn" -> FunctionKeys

    # -- key resolution (mod.rs:129-150) -------------------------------------

    def get_private_key(self, password: Optional[str] = None) -> acct.PrivateKey:
        if self.private_key is not None:
            if password is not None:
                raise ProgramManagerError("password given but key is not encrypted")
            return self.private_key
        if password is None:
            raise ProgramManagerError("password required for encrypted key")
        return encryptor.decrypt_private_key_with_secret(
            self.private_key_ciphertext, password
        )

    # -- program registry ----------------------------------------------------

    def add_program(self, source: str):
        self.registry.add(parse_program(source))

    def find_program(self, program_id: str):
        """Local registry first, then on-chain (resolver.rs:21-23)."""
        if program_id in self.registry.programs:
            return self.registry.programs[program_id]
        src = self.api_client.get_program(program_id)
        prog = parse_program(src)
        self.registry.add(prog)
        return prog

    def _load_imports(self, program_id: str):
        prog = self.find_program(program_id)
        for imp in prog.imports:
            self._load_imports(imp)

    def on_chain_program_state(self, source: str) -> OnChainProgramState:
        """network.rs:40-51."""
        prog = parse_program(source)
        try:
            chain_src = self.api_client.get_program(prog.id)
        except Exception:
            return OnChainProgramState.NotDeployed
        same = chain_src.strip() == source.strip()
        return OnChainProgramState.Same if same else OnChainProgramState.Different

    # -- execution ------------------------------------------------------------

    def _make_transition(
        self,
        program_id: str,
        function: str,
        inputs: List,
        private_key: acct.PrivateKey,
        prove: bool,
    ):
        """Interpret (and optionally prove) one transition. Returns
        (TransitionData, Transition, num_constraints)."""
        caller = private_key.address().x
        sk = private_key.sk
        num_constraints = 0
        if prove:
            from ..snark import pipeline
            from ..snark.serialize import proof_to_bytes

            keys = self._function_keys(program_id, function)
            ep = pipeline.prove_execution(
                keys, self.registry, inputs, caller=caller
            )
            tr = ep.transition
            public_inputs = ep.public_inputs
            proof_bytes = proof_to_bytes(
                ep.proof, keys.index.n, keys.index.m, keys.index.ell
            )
            num_constraints = keys.constraint_counts["total"]
        else:
            tr = Interpreter(self.registry).execute(
                program_id, function, inputs, caller=caller
            )
            public_inputs = [domain_tag(f"{program_id}/{function}")]
            for v in inputs:
                public_inputs.append(
                    v.commitment() if isinstance(v, Record) else _plain_input_id(v)
                )
            for v in tr.outputs:
                public_inputs.append(
                    v.commitment() if isinstance(v, Record) else _plain_output_id(v)
                )
            proof_bytes = None
        # inclusion-proof preparation for consumed records — the
        # `Trace::prepare(Query)` stage (SURVEY.md §3.1): fetch state paths
        # from the node so the ledger can check the spent records existed.
        inclusion = []
        if hasattr(self.api_client, "get_state_path"):
            for r in tr.consumed_records:
                cm = r.commitment()
                try:
                    root, path = self.api_client.get_state_path(cm)
                    inclusion.append((cm, root, path))
                except Exception:
                    pass  # e.g. burner/offline records; ledger enforces policy
        td = TransitionData(
            id=TransitionData.fresh_id(),
            program_id=program_id,
            function=function,
            public_inputs=public_inputs,
            serial_numbers=[r.serial_number(sk) for r in tr.consumed_records],
            output_commitments=[r.commitment() for r in tr.created_records],
            output_ciphertexts=[RecordCiphertext.encrypt(r) for r in tr.created_records],
            finalize_args=tr.finalize_args,
            proof=proof_bytes,
            inclusion_proofs=inclusion or None,
        )
        return td, tr, num_constraints

    def _function_keys(self, program_id: str, function: str):
        from ..snark import pipeline

        key = f"{program_id}/{function}"
        if key not in self._key_cache:
            self._key_cache[key] = pipeline.synthesize_keys(
                self.registry, program_id, function, device=self.device
            )
        return self._key_cache[key]

    def execute_program(
        self,
        program_id: str,
        function: str,
        inputs: List,
        fee: int = 0,
        fee_record: Optional[Record] = None,
        password: Optional[str] = None,
        prove: bool = False,
    ) -> str:
        """Full execute flow (execute.rs:94-146). Returns the broadcast
        transaction id."""
        private_key = self.get_private_key(password)
        self._load_imports(program_id)

        # authorization: sign the input IDs before proving (SURVEY §3.1)
        input_ids = [
            v.commitment() if isinstance(v, Record) else _plain_input_id(v)
            for v in inputs
        ]
        auth = Authorization.sign(private_key, program_id, function, input_ids)

        td, _tr, n_constraints = self._make_transition(
            program_id, function, inputs, private_key, prove
        )
        fee_td = self._fee_transition(private_key, fee, fee_record, prove)
        tx = Transaction(
            id=Transaction.fresh_id("execute"),
            kind="execute",
            execution=Execution([td], authorization=auth),
            fee_transition=fee_td,
            fee=fee,
        )
        self._register_vks(program_id, prove)
        return self.api_client.transaction_broadcast(tx)

    def _fee_transition(
        self,
        private_key: acct.PrivateKey,
        fee: int,
        fee_record: Optional[Record],
        prove: bool,
    ) -> Optional[TransitionData]:
        if fee <= 0:
            return None
        self.find_program("credits.aleo")
        if fee_record is None:
            fee_record = self.record_finder.find_one_record(private_key, fee)
        td, _tr, _n = self._make_transition(
            "credits.aleo", "fee", [fee_record, Value("u64", fee)], private_key, prove
        )
        if prove:
            self._register_vks("credits.aleo", prove)
        return td

    def _register_vks(self, program_id: str, prove: bool):
        """Publish cached verifying keys to a local ledger backend so it can
        verify broadcast proofs (deploy-time VK registration role)."""
        if not prove or not hasattr(self.api_client, "ledger"):
            return
        for key, fk in self._key_cache.items():
            self.api_client.ledger.function_vks[key] = fk.vk

    # -- deployment (deploy.rs:21-143) ----------------------------------------

    def deploy_program(
        self,
        source: str,
        fee: int = 0,
        fee_record: Optional[Record] = None,
        password: Optional[str] = None,
        prove: bool = False,
    ) -> str:
        private_key = self.get_private_key(password)
        prog = parse_program(source)
        state = self.on_chain_program_state(source)
        if state != OnChainProgramState.NotDeployed:
            raise ProgramManagerError(
                f"program {prog.id} already exists on chain ({state.value})"
            )
        # import checks (deploy.rs:66-90)
        for imp in prog.imports:
            try:
                self.api_client.get_program(imp)
            except Exception as e:
                raise ProgramManagerError(
                    f"import {imp} is not deployed on chain"
                ) from e
        self.registry.add(prog)
        vk_ids: Dict[str, str] = {}
        total_constraints = 0
        if prove:
            for fname in prog.functions:
                fk = self._function_keys(prog.id, fname)
                total_constraints += fk.constraint_counts["total"]
                vk_ids[fname] = hashlib.sha256(
                    str(fk.vk.index_commitments).encode()
                ).hexdigest()[:16]
        owner = private_key.address().to_string()
        sig = private_key.sign([domain_tag(prog.id)])
        fee_td = self._fee_transition(private_key, fee, fee_record, prove)
        tx = Transaction(
            id=Transaction.fresh_id("deploy"),
            kind="deploy",
            deployment=Deployment(prog.id, source, vk_ids, owner, sig),
            fee_transition=fee_td,
            fee=fee,
        )
        self._register_vks(prog.id, prove)
        return self.api_client.transaction_broadcast(tx)

    # -- transfers (transfer.rs:23-110) ---------------------------------------

    def transfer(
        self,
        amount: int,
        fee: int,
        recipient: str,
        transfer_type: TransferType = TransferType.Private,
        password: Optional[str] = None,
        amount_record: Optional[Record] = None,
        fee_record: Optional[Record] = None,
        prove: bool = False,
    ) -> str:
        private_key = self.get_private_key(password)
        self.find_program("credits.aleo")
        recipient_v = Value("address", acct.address_to_field(recipient))
        # input shapes per TransferType (transfer.rs:57-96)
        if transfer_type in (TransferType.Private, TransferType.PrivateToPublic):
            if amount_record is None:
                if fee > 0 and fee_record is None:
                    amount_record, fee_record = (
                        self.record_finder.find_amount_and_fee_records(
                            amount, fee, private_key
                        )
                    )
                else:
                    amount_record = self.record_finder.find_one_record(
                        private_key, amount
                    )
            inputs = [amount_record, recipient_v, Value("u64", amount)]
        else:
            inputs = [recipient_v, Value("u64", amount)]
        return self.execute_program(
            "credits.aleo",
            transfer_type.value,
            inputs,
            fee=fee,
            fee_record=fee_record,
            password=password if self.private_key is None else None,
            prove=prove,
        )

    def join(
        self,
        record_one: Record,
        record_two: Record,
        fee: int = 0,
        fee_record: Optional[Record] = None,
        password: Optional[str] = None,
        prove: bool = False,
    ) -> str:
        """Merge two credits records into one (`credits.aleo/join`; the wasm
        manager surface at upstream:wasm/src/programs/manager/join.rs:57)."""
        self.find_program("credits.aleo")
        return self.execute_program(
            "credits.aleo", "join", [record_one, record_two],
            fee=fee, fee_record=fee_record,
            password=password if self.private_key is None else None,
            prove=prove,
        )

    def split(
        self,
        amount_record: Record,
        split_amount: int,
        password: Optional[str] = None,
        prove: bool = False,
    ) -> str:
        """Split a credits record in two (`credits.aleo/split`; fee-less by
        protocol, upstream:wasm/src/programs/manager/split.rs:52)."""
        self.find_program("credits.aleo")
        return self.execute_program(
            "credits.aleo", "split",
            [amount_record, Value("u64", split_amount)],
            fee=0,
            password=password if self.private_key is None else None,
            prove=prove,
        )

    # -- fee estimation (execute.rs:184-234, deploy.rs:149-169) ---------------

    def estimate_execution_fee(self, program_id: str, function: str, inputs: List) -> int:
        from ..program.synthesizer import synthesize_execution

        self._load_imports(program_id)
        syn = synthesize_execution(
            self.registry, program_id, function, inputs, caller=1,
            rng_nonce=lambda: 1,
        )
        prog = self.registry.get(program_id)
        fin = prog.finalizes.get(function)
        n_fin = len(fin.instructions) if fin else 0
        return execution_cost(
            syn.constraint_counts["total"], n_fin, len(prog.source)
        )

    def estimate_deployment_fee(self, source: str) -> int:
        from ..snark import pipeline

        prog = parse_program(source)
        self.registry.add(prog)
        total = 0
        for fname in prog.functions:
            from ..program.synthesizer import synthesize_execution

            syn = synthesize_execution(
                self.registry, prog.id, fname,
                pipeline.burner_inputs(prog, fname), caller=1,
                rng_nonce=lambda: 1,
            )
            total += syn.constraint_counts["total"]
        return deployment_cost(total, len(source)) + namespace_cost(prog.id)

    def estimate_namespace_fee(self, program_id: str) -> int:
        return namespace_cost(program_id)
