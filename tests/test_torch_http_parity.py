"""The port's HttpAPIClient against its own DevServer on localhost, on the
CPU, and the server's node GET replies against the JAX package's.

The cases of tests/test_http_parity.py that Tier-1 runs, on the port
(`device="cpu"`, no proofs): chain state, programs, the scan and unspent
records over HTTP, a transfer end to end, state paths, a refused broadcast.
Then every node GET route of the port's server is held against the JAX
DevServer's `handle_node_get` over a JAX `LocalAPIClient` whose ledger was
minted and driven with the same arguments, tolerance 0: the genesis block
JSON, the blocks, the state root, state paths, transactions, programs,
mappings and searches. Transaction ids, record nonces and encryption
nonces are fresh randomness in both packages, so each module that draws
them draws here from a sequence with one seed.
"""

import json
import random
import urllib.request

import pytest

from aleo_tpu.program import interpreter as jinterpreter
from aleo_tpu.sdk import account as jaccount
from aleo_tpu.sdk import transactions as jtransactions
from aleo_tpu.sdk.account import PrivateKey as JPrivateKey
from aleo_tpu.sdk.api_client import LocalAPIClient as JClient
from aleo_tpu.sdk.dev_server import DevServer as JDevServer
from aleo_tpu.sdk.ledger import Ledger as JLedger
from aleo_tpu.sdk.program_manager import ProgramManager as JManager
from aleo_tpu.sdk.program_manager import TransferType as JTransferType
from aleo_tpu_torch.program import interpreter
from aleo_tpu_torch.sdk import account, transactions
from aleo_tpu_torch.sdk.account import PrivateKey
from aleo_tpu_torch.sdk.api_client import ApiError, HttpAPIClient, LocalAPIClient
from aleo_tpu_torch.sdk.dev_server import DevServer
from aleo_tpu_torch.sdk.ledger import Ledger
from aleo_tpu_torch.sdk.program_manager import ProgramManager, TransferType

CPU = "cpu"


@pytest.fixture
def http_env():
    ledger = Ledger()
    alice = PrivateKey(seed=4001)
    ledger.genesis_mint(alice.address().to_string(), 10_000_000, n_records=4)
    srv = DevServer(LocalAPIClient(ledger, device=CPU), host="127.0.0.1", port=0,
                    device=CPU)
    srv.start(background=True)
    client = HttpAPIClient(f"http://127.0.0.1:{srv.port}", device=CPU)
    yield client, alice, ledger
    srv.stop()


def test_chain_state_endpoints(http_env):
    client, _alice, ledger = http_env
    assert client.latest_height() == ledger.latest_height
    assert client.latest_hash() == ledger.latest_hash
    blk = client.latest_block()
    assert blk.height == ledger.latest_height
    assert blk.hash == ledger.latest_hash
    blocks = client.get_blocks(0, client.latest_height() + 1)
    assert [b.height for b in blocks] == list(range(ledger.latest_height + 1))
    assert client.get_state_root() == ledger.state_root()
    with pytest.raises(ApiError):
        client.get_block(10_000)


def test_program_endpoints(http_env):
    client, _alice, _ledger = http_env
    src = client.get_program("credits.aleo")
    assert "program credits.aleo" in src
    assert "account" in client.get_program_mappings("credits.aleo")
    with pytest.raises(ApiError):
        client.get_program("missing.aleo")


def test_scan_and_unspent_over_http(http_env):
    client, alice, _ledger = http_env
    cts = client.scan(alice.view_key(), 0, client.latest_height() + 1)
    assert len(cts) == 4
    found = client.get_unspent_records(alice)
    assert sum(r.entries["microcredits"].data for _c, r in found) == 10_000_000


def test_transfer_end_to_end_over_http(http_env):
    """ProgramManager driving a private transfer entirely through HTTP:
    record discovery, execution, broadcast, and post-state checks."""
    client, alice, ledger = http_env
    bob = PrivateKey(seed=4002)
    pm = ProgramManager(client, private_key=alice, device=CPU)
    tx_id = pm.transfer(300_000, 0, bob.address().to_string(), TransferType.Private)
    assert tx_id.startswith("at1")
    assert client.find_block_hash(tx_id) == ledger.latest_hash
    tx = client.get_transaction(tx_id)
    assert tx.id == tx_id
    bob_found = client.get_unspent_records(bob)
    assert [r.entries["microcredits"].data for _c, r in bob_found] == [300_000]
    alice_total = sum(
        r.entries["microcredits"].data for _c, r in client.get_unspent_records(alice)
    )
    assert alice_total == 10_000_000 - 300_000


def test_state_path_over_http(http_env):
    client, alice, ledger = http_env
    cts = client.scan(alice.view_key(), 0, client.latest_height() + 1)
    root, path = client.get_state_path(cts[0].commitment)
    assert (root, path) == ledger.get_state_path(cts[0].commitment)


def test_broadcast_rejects_garbage(http_env):
    client, _alice, _ledger = http_env
    with pytest.raises(ApiError):
        client._post("transaction/broadcast", {"id": "at1junk", "type": "execute"})


# -- the node GET surface against the JAX server -------------------------------


class _Draws:
    """`secrets` stand-in: token_hex and randbits from one seeded sequence."""

    def __init__(self, seed):
        self.rng = random.Random(seed)

    def token_hex(self, n):
        return self.rng.randbytes(n).hex()

    def randbits(self, k):
        return self.rng.getrandbits(k)


def test_node_get_replies_match_jax(monkeypatch):
    for mod in (transactions, account, interpreter, jtransactions, jaccount, jinterpreter):
        monkeypatch.setattr(mod, "secrets", _Draws(17))
    alice, bob = PrivateKey(seed=4301), PrivateKey(seed=4302)
    ledger, jledger = Ledger(), JLedger()
    ledger.genesis_mint(alice.address().to_string(), 10_000_000, n_records=4)
    jledger.genesis_mint(alice.address().to_string(), 10_000_000, n_records=4)
    local, jlocal = LocalAPIClient(ledger, device=CPU), JClient(jledger)
    tx_id = ProgramManager(local, private_key=alice, device=CPU).transfer(
        1_000_000, 0, bob.address().to_string(), TransferType.PrivateToPublic)
    jtx_id = JManager(jlocal, private_key=JPrivateKey(seed=4301)).transfer(
        1_000_000, 0, bob.address().to_string(), JTransferType.PrivateToPublic)
    assert tx_id == jtx_id
    tx = ledger.transactions[tx_id]
    cm = tx.transitions()[0].output_commitments[0]
    sn = tx.transitions()[0].serial_numbers[0]
    paths = [
        "latest/height", "latest/hash", "latest/block", "latest/stateRoot",
        "block/0", "block/1", "block/2", "blocks?start=0&end=3",
        f"transaction/{tx_id}", "memoryPool/transactions", f"statePath/{cm}",
        "program/credits.aleo", "program/credits.aleo/mappings",
        "program/credits.aleo/import_resolution",
        f"program/credits.aleo/mapping/account/{bob.address().x}",
        f"find/blockHash/{tx_id}", f"find/transitionID/{sn}",
    ]
    srv = DevServer(local, host="127.0.0.1", port=0, device=CPU)
    srv.start(background=True)
    jsrv = JDevServer(jlocal)
    try:
        for path in paths:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/testnet3/{path}") as r:
                got = json.loads(r.read())
            handled, want = jsrv.handle_node_get(f"/testnet3/{path}")
            assert handled and got == json.loads(json.dumps(want)), path
    finally:
        srv.stop()
    assert got == tx.transitions()[0].id
    assert ledger.state_root() == jledger.state_root()
    assert local.get_mapping_value("credits.aleo", "account", bob.address().x) == 1_000_000
