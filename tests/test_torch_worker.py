"""The port's proving worker (`aleo_tpu_torch.sdk.worker`) on the CPU, against
the JAX package's.

The cases of tests/test_worker.py on the port (`device="cpu"`, no proofs):
a local execution, deploy then execute on chain, transfer, split and join,
fee estimates and errors. The fee estimates are held against the JAX
worker's replies to the same messages, tolerance 0. Then F3 in the worker: a
join with a fee spends three distinct records and carries a fee transition
(the JAX worker spends one record twice here); a split takes a record below
twice its amount (the JAX worker finds none).
"""

import pytest
import torch

from aleo_tpu.sdk.account import PrivateKey as JPrivateKey
from aleo_tpu.sdk.api_client import LocalAPIClient as JClient
from aleo_tpu.sdk.ledger import Ledger as JLedger
from aleo_tpu.sdk.worker import ProvingWorker as JWorker
from aleo_tpu_torch.sdk.account import PrivateKey
from aleo_tpu_torch.sdk.api_client import LocalAPIClient
from aleo_tpu_torch.sdk.ledger import Ledger
from aleo_tpu_torch.sdk.worker import ProvingWorker

CPU = "cpu"
DOUBLER = (
    "program wdouble.aleo;\n\nfunction double:\n"
    "    input r0 as u32.private;\n    add r0 r0 into r1;\n"
    "    output r1 as u32.private;\n"
)


def _credits(ledger, pk):
    return sorted(r.entries["microcredits"].data
                  for _c, r in LocalAPIClient(ledger, device=CPU).get_unspent_records(pk))


@pytest.fixture
def worker():
    ledger = Ledger()
    alice = PrivateKey(seed=5001)
    ledger.genesis_mint(alice.address().to_string(), 10_000_000, n_records=3)
    w = ProvingWorker(LocalAPIClient(ledger, device=CPU), device=CPU).start()
    yield w, alice, ledger
    w.stop()


@pytest.fixture
def jworker():
    ledger = JLedger()
    ledger.genesis_mint(JPrivateKey(seed=5001).address().to_string(), 10_000_000,
                        n_records=3)
    w = JWorker(JClient(ledger)).start()
    yield w, ledger
    w.stop()


def test_worker_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProvingWorker()
    assert ProvingWorker(device=CPU).api_client.device == torch.device(CPU)


def test_local_execution_message(worker):
    w, alice, _ = worker
    resp = w.call({
        "type": "ALEO_EXECUTE_PROGRAM_LOCAL",
        "localProgram": DOUBLER,
        "aleoFunction": "double",
        "inputs": ["21u32"],
        "privateKey": alice.to_string(),
    })
    assert resp["type"] == "OFFLINE_EXECUTION_COMPLETED"
    assert resp["outputs"] == ["42"]


def test_deploy_then_execute_on_chain(worker):
    w, alice, ledger = worker
    resp = w.call({
        "type": "ALEO_DEPLOY", "program": DOUBLER,
        "privateKey": alice.to_string(),
    })
    assert resp["type"] == "DEPLOY_TRANSACTION_COMPLETED"
    resp = w.call({
        "type": "ALEO_EXECUTE_PROGRAM_ON_CHAIN",
        "programId": "wdouble.aleo",
        "aleoFunction": "double",
        "inputs": ["8u32"],
        "privateKey": alice.to_string(),
    })
    assert resp["type"] == "EXECUTION_TRANSACTION_COMPLETED"
    assert resp["transaction"].startswith("at1")
    assert ledger.transactions[resp["transaction"]].execution.transitions[0].function == "double"


def test_transfer_split_join_messages(worker):
    w, alice, ledger = worker
    bob = PrivateKey(seed=5002)
    resp = w.call({
        "type": "ALEO_TRANSFER", "amountCredits": 400_000,
        "recipient": bob.address().to_string(),
        "privateKey": alice.to_string(),
    })
    assert resp["type"] == "TRANSFER_TRANSACTION_COMPLETED"
    assert _credits(ledger, bob) == [400_000]
    resp = w.call({
        "type": "ALEO_SPLIT", "splitAmount": 100_000,
        "privateKey": bob.to_string(),
    })
    assert resp["type"] == "SPLIT_TRANSACTION_COMPLETED"
    assert _credits(ledger, bob) == [100_000, 300_000]
    resp = w.call({
        "type": "ALEO_JOIN", "privateKey": bob.to_string(),
    })
    assert resp["type"] == "JOIN_TRANSACTION_COMPLETED"
    assert _credits(ledger, bob) == [400_000]


def test_fee_estimates_match_jax_and_errors(worker, jworker):
    w, alice, _ = worker
    jw, _jledger = jworker
    messages = [
        {"type": "ALEO_ESTIMATE_DEPLOYMENT_FEE", "program": DOUBLER,
         "privateKey": alice.to_string()},
        {"type": "ALEO_ESTIMATE_EXECUTION_FEE", "remoteProgram": DOUBLER,
         "programId": "wdouble.aleo", "aleoFunction": "double", "inputs": ["8u32"],
         "privateKey": alice.to_string(), "id": 7},
        {"type": "ALEO_ESTIMATE_EXECUTION_FEE", "programId": "credits.aleo",
         "aleoFunction": "transfer_public",
         "inputs": [alice.address().to_string(), "5u64"],
         "privateKey": alice.to_string()},
    ]
    for msg in messages:
        resp = w.call(dict(msg))
        assert resp == jw.call(dict(msg))
    assert resp["executionFee"] > 0
    with pytest.raises(RuntimeError):
        w.call({"type": "NO_SUCH_OP", "privateKey": alice.to_string()})


# -- F3 in the worker -----------------------------------------------------------


def _join_with_fee(w, pk, ledger):
    resp = w.call({"type": "ALEO_JOIN", "privateKey": pk.to_string(), "fee": 50_000})
    tx = ledger.transactions[resp["transaction"]]
    return tx, [sn for t in tx.transitions() for sn in t.serial_numbers]


def test_join_with_fee_spends_three_distinct_records(worker, jworker):
    w, alice, ledger = worker
    tx, serials = _join_with_fee(w, alice, ledger)
    assert len(serials) == 3 == len(set(serials))
    assert tx.fee == 50_000 and tx.fee_transition.function == "fee"
    assert _credits(ledger, alice) == [3_283_333, 6_666_666]
    # the JAX worker takes the fee record in a second search: here the first
    # joined record, spent twice in one transaction (F3, kept there)
    jw, jledger = jworker
    _jtx, jserials = _join_with_fee(jw, JPrivateKey(seed=5001), jledger)
    assert len(jserials) == 3 and len(set(jserials)) == 2


def test_split_takes_a_record_below_twice_the_amount(worker, jworker):
    """Each genesis record holds 3,333,333: a split of 2M finds one in the
    port; the JAX worker asks for 4M and finds none (F3, kept there)."""
    w, alice, ledger = worker
    msg = {"type": "ALEO_SPLIT", "splitAmount": 2_000_000, "privateKey": alice.to_string()}
    resp = w.call(dict(msg))
    assert resp["type"] == "SPLIT_TRANSACTION_COMPLETED"
    assert _credits(ledger, alice) == [1_333_333, 2_000_000, 3_333_333, 3_333_333]
    jw, _jledger = jworker
    with pytest.raises(RuntimeError, match="4000000"):
        jw.call(dict(msg))
