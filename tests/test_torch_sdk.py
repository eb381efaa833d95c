"""The port's host SDK (`aleo_tpu_torch.sdk`) on the CPU, against the JAX
package's (`aleo_tpu.sdk`).

The cases of tests/test_sdk.py that Tier-1 runs, on the port with
`device="cpu"` and no proofs (`prove=False`): the encryptor, genesis and
scan, private and public transfers with their mappings, deploy and execute,
the record finder, fees, the manager's key rules, authorizations, state
paths, and the scan's batch path (the device ECDH, `BATCH_ECDH_MIN` = 1).
Every value that does not depend on fresh randomness is compared with the
JAX SDK's for the same inputs, tolerance 0: the encryptor's ciphertext at a
fixed nonce, record commitments, the state tree's root and paths, serial
numbers, signatures, fee estimates, and the wire JSON (the port's block read
and written again by the JAX codecs). The port's ledger also rejects a
transaction that spends one record twice, which the JAX ledger accepts.
"""

import pytest

from aleo_tpu.program.values import Record as JRecord, Value as JValue
from aleo_tpu.sdk import encryptor as jenc
from aleo_tpu.sdk import wire as jwire
from aleo_tpu.sdk.account import PrivateKey as JPrivateKey
from aleo_tpu.sdk.api_client import LocalAPIClient as JClient
from aleo_tpu.sdk.ledger import Ledger as JLedger
from aleo_tpu.sdk.program_manager import ProgramManager as JManager
from aleo_tpu.sdk.transactions import Authorization as JAuthorization
from aleo_tpu_torch.program.values import Record, Value
from aleo_tpu_torch.sdk import api_client as ac
from aleo_tpu_torch.sdk import encryptor
from aleo_tpu_torch.sdk import wire
from aleo_tpu_torch.sdk.account import PrivateKey
from aleo_tpu_torch.sdk.api_client import ApiError, LocalAPIClient
from aleo_tpu_torch.sdk.ledger import Ledger
from aleo_tpu_torch.sdk.merkle import verify_path
from aleo_tpu_torch.sdk.program_manager import (
    OnChainProgramState,
    ProgramManager,
    ProgramManagerError,
    TransferType,
)
from aleo_tpu_torch.sdk.records import RecordFinder, RecordFinderError
from aleo_tpu_torch.sdk.transactions import Authorization

CPU = "cpu"


def _credits(rec):
    return rec.entries["microcredits"].data


def _jax_record(rec: Record) -> JRecord:
    return JRecord(rec.program, rec.type_, rec.owner, rec.gates,
                   {k: JValue(v.type_, v.data) for k, v in rec.entries.items()}, rec.nonce)


# -- encryptor (encryptor.rs:84-152 shapes) ----------------------------------


def test_encryptor_roundtrip_and_fixed_nonce_match_jax():
    pk = PrivateKey(seed=12345)
    ct = encryptor.encrypt_private_key_with_secret(pk, "mypassword")
    rec = encryptor.decrypt_private_key_with_secret(ct, "mypassword")
    assert rec.seed == pk.seed
    assert rec.address().to_string() == pk.address().to_string()
    assert pk.address().to_string() == JPrivateKey(seed=12345).address().to_string()
    fixed = encryptor.encrypt_private_key_with_secret(pk, "pw", nonce=777)
    jfixed = jenc.encrypt_private_key_with_secret(JPrivateKey(seed=12345), "pw", nonce=777)
    assert fixed.to_string() == jfixed.to_string()
    # a ciphertext of either package opens under the other's
    back = jenc.PrivateKeyCiphertext.from_string(ct.to_string())
    assert jenc.decrypt_private_key_with_secret(back, "mypassword").seed == pk.seed


def test_encryptor_wrong_password_fails():
    pk = PrivateKey(seed=77)
    ct = encryptor.encrypt_private_key_with_secret(pk, "mypassword")
    with pytest.raises(encryptor.DecryptionError):
        encryptor.decrypt_private_key_with_secret(ct, "wrong_password")


def test_encryptor_nondeterministic_but_consistent():
    pk = PrivateKey(seed=99)
    c1 = encryptor.encrypt_private_key_with_secret(pk, "pw")
    c2 = encryptor.encrypt_private_key_with_secret(pk, "pw")
    assert c1 != c2
    assert encryptor.decrypt_private_key_with_secret(c1, "pw").seed == pk.seed
    assert encryptor.decrypt_private_key_with_secret(c2, "pw").seed == pk.seed


def test_encryptor_string_roundtrip():
    pk = PrivateKey(seed=4242)
    ct = encryptor.encrypt_private_key_with_secret(pk, "pw")
    assert encryptor.PrivateKeyCiphertext.from_string(ct.to_string()) == ct


# -- ledger + api client ------------------------------------------------------


@pytest.fixture
def chain():
    ledger = Ledger()
    alice = PrivateKey(seed=1001)
    bob = PrivateKey(seed=1002)
    ledger.genesis_mint(alice.address().to_string(), 10_000_000, n_records=4)
    client = LocalAPIClient(ledger, device=CPU)
    return ledger, client, alice, bob


@pytest.fixture
def jchain():
    ledger = JLedger()
    alice = JPrivateKey(seed=1001)
    ledger.genesis_mint(alice.address().to_string(), 10_000_000, n_records=4)
    return ledger, JClient(ledger), alice


def test_genesis_and_scan(chain, jchain):
    ledger, client, alice, bob = chain
    jledger, jclient, jalice = jchain
    assert client.latest_height() == 1
    recs = client.get_unspent_records(alice)
    assert len(recs) == 4
    assert sum(_credits(r) for _c, r in recs) == 10_000_000
    assert client.get_unspent_records(bob) == []
    assert len(client.scan(alice.view_key(), 0, 10)) == 4
    # commitments, the state tree and serial numbers as the JAX SDK's
    assert sorted(ledger.commitment_index) == sorted(jledger.commitment_index)
    assert ledger.commitment_tree.root() == jledger.commitment_tree.root()
    jrecs = {c: r for c, r in jclient.get_unspent_records(jalice)}
    for c, r in recs:
        assert r.commitment() == c == jrecs[c].commitment()
        assert r.serial_number(alice.sk) == jrecs[c].serial_number(jalice.sk)


def test_transfer_private_roundtrip(chain):
    """transfer.rs:220-304 journey, private leg."""
    ledger, client, alice, bob = chain
    pm = ProgramManager(client, private_key=alice, device=CPU)
    spent_rec = pm.record_finder.find_one_record(alice, 1_000_000)
    tx_id = pm.transfer(1_000_000, 0, bob.address().to_string(), TransferType.Private)
    assert client.get_transaction(tx_id).kind == "execute"
    bob_recs = client.get_unspent_records(bob)
    assert [_credits(r) for _c, r in bob_recs] == [1_000_000]
    alice_total = sum(_credits(r) for _c, r in client.get_unspent_records(alice))
    assert alice_total == 9_000_000
    spent = next(iter(ledger.spent_serials))
    assert client.find_transition_id(spent) is not None
    # the spent serial is the JAX SDK's serial of the same record
    assert spent == _jax_record(spent_rec).serial_number(JPrivateKey(seed=1001).sk)


def test_transfer_public_and_mappings(chain):
    """Public transfer with mapping-value assertions (transfer.rs:283-293)."""
    ledger, client, alice, bob = chain
    pm = ProgramManager(client, private_key=alice, device=CPU)
    pm.transfer(2_000_000, 0, alice.address().to_string(), TransferType.PrivateToPublic)
    assert client.get_mapping_value("credits.aleo", "account", alice.address().x) == 2_000_000
    pm.transfer(500_000, 0, bob.address().to_string(), TransferType.Public)
    assert client.get_mapping_value("credits.aleo", "account", alice.address().x) == 1_500_000
    assert client.get_mapping_value("credits.aleo", "account", bob.address().x) == 500_000
    pm_bob = ProgramManager(client, private_key=bob, device=CPU)
    pm_bob.transfer(250_000, 0, bob.address().to_string(), TransferType.PublicToPrivate)
    assert client.get_mapping_value("credits.aleo", "account", bob.address().x) == 250_000
    assert [_credits(r) for _c, r in client.get_unspent_records(bob)] == [250_000]


MULTIPLY = """
program multiply_test.aleo;

function multiply:
    input r0 as u32.public;
    input r1 as u32.private;
    mul r0 r1 into r2;
    output r2 as u32.private;
"""

IMPORTER = """
import multiply_test.aleo;
program importer.aleo;

function main:
    input r0 as u32.public;
    call multiply_test.aleo/multiply r0 5u32 into r1;
    output r1 as u32.private;
"""


def test_deploy_and_execute(chain):
    ledger, client, alice, bob = chain
    pm = ProgramManager(client, private_key=alice, device=CPU)
    assert pm.on_chain_program_state(MULTIPLY) == OnChainProgramState.NotDeployed
    tx_id = pm.deploy_program(MULTIPLY)
    assert client.get_transaction(tx_id).kind == "deploy"
    assert pm.on_chain_program_state(MULTIPLY) == OnChainProgramState.Same
    with pytest.raises(ProgramManagerError):
        pm.deploy_program(MULTIPLY)
    pm2 = ProgramManager(client, private_key=bob, device=CPU)
    tx2 = pm2.execute_program("multiply_test.aleo", "multiply", [Value("u32", 6), Value("u32", 7)])
    tx = client.get_transaction(tx2)
    assert tx.execution.authorization.verify()
    # the public inputs (tag, input IDs, output IDs) are the JAX SDK's
    jl = JLedger()
    jclient = JClient(jl)
    JManager(jclient, private_key=JPrivateKey(seed=1001)).deploy_program(MULTIPLY)
    jtx = jclient.get_transaction(JManager(jclient, private_key=JPrivateKey(seed=1002)).execute_program(
        "multiply_test.aleo", "multiply", [JValue("u32", 6), JValue("u32", 7)]))
    assert tx.transitions()[0].public_inputs == jtx.transitions()[0].public_inputs
    assert tx.execution.authorization.signature == jtx.execution.authorization.signature


def test_deploy_import_checks(chain):
    """Imports must already be on chain (deploy.rs:66-90)."""
    ledger, client, alice, bob = chain
    pm = ProgramManager(client, private_key=alice, device=CPU)
    with pytest.raises(ProgramManagerError):
        pm.deploy_program(IMPORTER)
    pm.deploy_program(MULTIPLY)
    pm.deploy_program(IMPORTER)
    assert "multiply_test.aleo" in client.get_program_imports("importer.aleo")


def test_record_finder_insufficient(chain):
    ledger, client, alice, bob = chain
    rf = RecordFinder(client)
    with pytest.raises(RecordFinderError):
        rf.find_one_record(bob, 1)
    rec = rf.find_one_record(alice, 2_000_000)
    assert _credits(rec) >= 2_000_000
    r1, r2 = rf.find_amount_and_fee_records(1_000_000, 500_000, alice)
    assert r1.commitment() != r2.commitment()


def test_fees_charged_and_estimated(chain, jchain):
    ledger, client, alice, bob = chain
    jledger, jclient, jalice = jchain
    pm = ProgramManager(client, private_key=alice, device=CPU)
    jpm = JManager(jclient, private_key=jalice)
    rec = Record("credits.aleo", "credits", alice.address().x, 0,
                 {"microcredits": Value("u64", 100)}, 1)
    est = pm.estimate_execution_fee(
        "credits.aleo", "transfer_private",
        [rec, Value("address", bob.address().x), Value("u64", 10)])
    assert est > 0
    assert est == jpm.estimate_execution_fee(
        "credits.aleo", "transfer_private",
        [_jax_record(rec), JValue("address", bob.address().x), JValue("u64", 10)])
    assert pm.estimate_deployment_fee(MULTIPLY) == jpm.estimate_deployment_fee(MULTIPLY)
    assert pm.estimate_namespace_fee("multiply_test.aleo") == 0
    assert pm.estimate_namespace_fee("abcd.aleo") == 10 ** 6 * 10 ** 6
    pm.transfer(1_000_000, 300_000, bob.address().to_string(), TransferType.Private)
    alice_total = sum(_credits(r) for _c, r in client.get_unspent_records(alice))
    assert alice_total == 10_000_000 - 1_000_000 - 300_000


def test_manager_key_rules(chain):
    ledger, client, alice, bob = chain
    with pytest.raises(ProgramManagerError):
        ProgramManager(client, device=CPU)
    ct = encryptor.encrypt_private_key_with_secret(alice, "pw")
    pm = ProgramManager(client, private_key_ciphertext=ct, device=CPU)
    with pytest.raises(ProgramManagerError):
        pm.get_private_key()
    assert pm.get_private_key("pw").seed == alice.seed
    pm2 = ProgramManager(client, private_key=alice, device=CPU)
    with pytest.raises(ProgramManagerError):
        pm2.get_private_key("pw")


def test_authorization_signature_matches_jax():
    alice = PrivateKey(seed=1001)
    auth = Authorization.sign(alice, "credits.aleo", "transfer_private", [1, 2, 3])
    assert auth.verify()
    jauth = JAuthorization.sign(JPrivateKey(seed=1001), "credits.aleo", "transfer_private", [1, 2, 3])
    assert (auth.caller, auth.signature) == (jauth.caller, jauth.signature)
    auth.input_ids[0] = 9
    assert not auth.verify()


def test_scan_uses_batch_path(chain, monkeypatch):
    """With BATCH_ECDH_MIN at 1 the scan takes the device ECDH (one ladder
    over the four genesis ciphertexts, on the CPU) and finds what the
    per-record host path finds."""
    ledger, client, alice, bob = chain
    calls = []
    real = ac.shared_secrets
    monkeypatch.setattr(ac, "shared_secrets",
                        lambda *a, **kw: calls.append(len(a[1])) or real(*a, **kw))
    monkeypatch.setattr(ac, "BATCH_ECDH_MIN", 1)
    recs_batch = client.get_unspent_records(alice)
    assert calls == [4]
    monkeypatch.setattr(ac, "BATCH_ECDH_MIN", 10_000)
    recs_host = client.get_unspent_records(alice)
    assert len(calls) == 1
    assert sorted(c for c, _ in recs_batch) == sorted(c for c, _ in recs_host)
    assert len(recs_host) == 4


def test_state_paths_and_inclusion_proofs(chain, jchain):
    """Merkle state paths (Trace::prepare twin)."""
    ledger, client, alice, bob = chain
    jledger, jclient, _ = jchain
    cm = next(iter(ledger.commitment_index))
    root, path = client.get_state_path(cm)
    assert (root, path) == jclient.get_state_path(cm)
    assert verify_path(root, cm, path)
    assert not verify_path(root, cm + 1, path)
    with pytest.raises(ApiError):
        client.get_state_path(123456789)
    pm = ProgramManager(client, private_key=alice, device=CPU)
    tx_id = pm.transfer(500_000, 0, bob.address().to_string(), TransferType.Private)
    tx = client.get_transaction(tx_id)
    t = tx.execution.transitions[0]
    assert t.inclusion_proofs, "consumed record must carry a state path"
    for (c, r, p) in t.inclusion_proofs:
        assert r in ledger.known_roots and verify_path(r, c, p)
    from aleo_tpu_torch.sdk.transactions import Transaction as Tx

    t.inclusion_proofs[0] = (t.inclusion_proofs[0][0] + 1, r, p)
    tx.id = Tx.fresh_id("execute")
    with pytest.raises(ApiError):
        client.transaction_broadcast(tx)


def test_wire_json_reads_back_in_the_jax_codecs(chain):
    """A block with a transfer, as the port writes it, is the JSON the JAX
    codecs write after reading it."""
    ledger, client, alice, bob = chain
    pm = ProgramManager(client, private_key=alice, device=CPU)
    tx_id = pm.transfer(700_000, 0, bob.address().to_string(), TransferType.Private)
    blk = wire.block_to_json(client.get_block(client.latest_height()))
    assert jwire.block_to_json(jwire.block_from_json(blk)) == blk
    tx = wire.transaction_to_json(client.get_transaction(tx_id))
    assert jwire.transaction_to_json(jwire.transaction_from_json(tx)) == tx
    assert wire.transaction_to_json(wire.transaction_from_json(tx)) == tx


def test_ledger_rejects_a_record_spent_twice_in_one_transaction(chain):
    """A transfer whose fee spends the amount's own record: two transitions
    with one serial number. The port's ledger rejects it and the chain is
    unchanged."""
    ledger, client, alice, bob = chain
    pm = ProgramManager(client, private_key=alice, device=CPU)
    rec = pm.record_finder.find_one_record(alice, 1_000_000)
    height = client.latest_height()
    with pytest.raises(ApiError, match="spent twice"):
        pm.transfer(1_000_000, 200_000, bob.address().to_string(), TransferType.Private,
                    amount_record=rec, fee_record=rec)
    assert client.latest_height() == height
    assert not ledger.spent_serials
    assert client.get_unspent_records(bob) == []
