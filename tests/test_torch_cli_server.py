"""The port's CLI (`aleo_tpu_torch.cli`) and development server
(`aleo_tpu_torch.sdk.dev_server`) on the CPU, against the JAX package's.

The cases of tests/test_cli_server.py on the port, with `--device cpu` /
`device="cpu"` and no proofs: `account`, the package commands, the devnet
with a transfer, and the server's routes over real HTTP with its key
resolution. What does not depend on fresh randomness is held against the JAX
CLI and server on the same inputs, tolerance 0: the output of `account new
--seed 123` and its AccountModel JSON, `build` and `run` output, and
`_parse_inputs` on every input spelling.

Then the repairs: F3 in the server (a join with a fee spends three distinct
records and carries a fee transition; a split takes a record below twice its
amount, which the JAX server refuses), the lock of `_build.library()` (two
threads at the first launch build once), the devnet file (the verifying
keys' SRS as numpy arrays, loaded onto the device asked for), and F6 (a block
read by its hash through `block/<hash>`, which the JAX server parses as a
height).
"""

import json
import os
import pickle
import subprocess
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from aleo_tpu import cli as jcli
from aleo_tpu.sdk.account import PrivateKey as JPrivateKey
from aleo_tpu.sdk.api_client import LocalAPIClient as JClient
from aleo_tpu.sdk.dev_server import DevServer as JDevServer
from aleo_tpu.sdk.dev_server import _parse_inputs as jparse_inputs
from aleo_tpu.sdk.ledger import Ledger as JLedger
from aleo_tpu_torch import _build, cli
from aleo_tpu_torch.pcs.srs import Srs
from aleo_tpu_torch.sdk import encryptor
from aleo_tpu_torch.sdk.account import PrivateKey
from aleo_tpu_torch.sdk.api_client import ApiError, HttpAPIClient, LocalAPIClient
from aleo_tpu_torch.sdk.dev_server import DevServer, _parse_inputs
from aleo_tpu_torch.sdk.development_client import (
    DevelopmentClient,
    DevelopmentClientError,
)
from aleo_tpu_torch.sdk.ledger import Ledger
from aleo_tpu_torch.snark.verifier import VerifyingKey

CPU = "cpu"


def _credits(client, pk):
    return sorted(r.entries["microcredits"].data for _c, r in client.get_unspent_records(pk))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# -- CLI ----------------------------------------------------------------------


def test_cli_account_new_and_write_match_jax(tmp_path, capsys):
    out_file = tmp_path / "account.json"
    jcli.main(["account", "new", "--seed", "123", "--write", str(out_file)])
    jout, jmodel = capsys.readouterr().out, json.loads(out_file.read_text())
    cli.main(["account", "new", "--seed", "123", "--write", str(out_file)])
    out, model = capsys.readouterr().out, json.loads(out_file.read_text())
    assert "aleo1" in out
    assert set(model) == {"private_key", "view_key", "address"}
    pk = PrivateKey.from_string(model["private_key"])
    assert pk.address().to_string() == model["address"]
    assert (out, model) == (jout, jmodel)


def test_cli_account_encrypt_decrypt(capsys):
    pk = PrivateKey(seed=5)
    cli.main(["account", "encrypt", "--key", pk.to_string(), "--password", "pw"])
    ct = capsys.readouterr().out.strip()
    cli.main(["account", "decrypt", "--ciphertext", ct, "--password", "pw"])
    out = capsys.readouterr().out
    assert pk.address().to_string() in out
    # the JAX CLI opens the port's ciphertext to the same account lines
    jcli.main(["account", "decrypt", "--ciphertext", ct, "--password", "pw"])
    assert capsys.readouterr().out == out


def test_cli_package_lifecycle_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cli.main(["new", "demo"])
    assert (tmp_path / "demo" / "program.json").exists()
    assert capsys.readouterr().out == "created package demo/\n"
    outs = []
    for main in (cli.main, jcli.main):
        main(["build", "--path", "demo"])
        main(["run", "hello", "2u32", "3u32", "--path", "demo"])
        outs.append(capsys.readouterr().out)
    assert "demo.aleo/hello" in outs[0] and "constraints" in outs[0]
    assert "output r0: 5" in outs[0]
    assert outs[0] == outs[1]
    assert (tmp_path / "demo" / "build" / "main.aleo").exists()
    cli.main(["clean", "--path", "demo"])
    assert not (tmp_path / "demo" / "build").exists()


def test_cli_devnet_and_execute(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(cli, "DEVNET_PATH", str(tmp_path / "devnet.pkl"))
    alice = PrivateKey(seed=88)
    cli.main(["devnet", "mint", "--address", alice.address().to_string(),
              "--amount", "5000000"])
    bob = PrivateKey(seed=89)
    cli.main([
        "transfer", "--amount", "100000", "--recipient",
        bob.address().to_string(), "--private-key", alice.to_string(),
        "--device", CPU,
    ])
    out = capsys.readouterr().out
    assert "transfer transaction: at1" in out
    cli.main(["devnet", "status"])
    out = capsys.readouterr().out
    assert "height: 2" in out


def test_cli_tensor_commands_need_a_device_without_cuda(tmp_path, monkeypatch, no_cuda):
    monkeypatch.setattr(cli, "DEVNET_PATH", str(tmp_path / "devnet.pkl"))
    alice = PrivateKey(seed=90)
    args = ["transfer", "--amount", "1", "--recipient", alice.address().to_string(),
            "--private-key", alice.to_string()]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["develop", "--port", "0"])


def test_parse_inputs_matches_jax():
    addr = PrivateKey(seed=3).address().to_string()
    raw = ["true", "false", addr, "5field", "7u8", "300u16", "70000u32", "5u64",
           "2u128", "-3i8", "-300i16", "5i32", "-5i64", "9i128",
           {"type": "u32", "value": 9}, {"type": "field", "value": 11}]
    got = [(v.type_, v.data) for v in _parse_inputs(raw)]
    want = [(v.type_, v.data) for v in jparse_inputs(raw)]
    assert got == want
    assert got[2] == ("address", PrivateKey(seed=3).address().x)
    for fn in (_parse_inputs, jparse_inputs):
        with pytest.raises(ValueError):
            fn(["5u7"])


# -- the devnet file (repair 3) ------------------------------------------------


class _Globals(pickle.Unpickler):
    """Unpickles and records the module of every global the pickle names."""

    def __init__(self, f):
        super().__init__(f)
        self.modules = set()

    def find_class(self, module, name):
        self.modules.add(module.split(".")[0])
        return super().find_class(module, name)


def test_devnet_file_holds_the_srs_in_host_form(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "DEVNET_PATH", str(tmp_path / "devnet.pkl"))
    srs = Srs.generate(7, device=CPU)
    ledger = Ledger()
    ledger.genesis_mint(PrivateKey(seed=91).address().to_string(), 1000)
    for fn in ("split", "join"):
        ledger.function_vks[f"credits.aleo/{fn}"] = VerifyingKey(8, 16, 2, [], srs)
    cli._save_ledger(ledger)
    assert ledger.function_vks["credits.aleo/join"].srs is srs   # left as it was
    with open(cli.DEVNET_PATH, "rb") as f:
        up = _Globals(f)
        up.load()
    assert "numpy" in up.modules and "torch" not in up.modules, up.modules
    for device in (CPU, "meta"):
        back = cli._load_ledger(device)
        a, b = (back.function_vks[f"credits.aleo/{fn}"] for fn in ("split", "join"))
        assert a.srs is b.srs
        assert a.srs.powers.x.device.type == device
        assert (a.srs.g2_gen, a.srs.g2_tau, a.srs.max_degree) == \
            (srs.g2_gen, srs.g2_tau, srs.max_degree)
        if device == CPU:
            for got, want in zip(a.srs.powers, srs.powers):
                assert torch.equal(got, want)
        assert back.latest_height == ledger.latest_height


# -- the build lock (repair 2) --------------------------------------------------


def test_two_threads_at_the_first_launch_build_once(tmp_path, monkeypatch):
    compiles, links, loads = [], [], []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            compiles.append(cmd)

        def communicate(self):
            time.sleep(0.05)        # the other thread arrives while this one builds
            return "", None

    def run(cmd, **kw):
        links.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    def cdll(path):
        loads.append(path)
        return Lib()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    start, libs = threading.Barrier(2), []

    def first_launch():
        start.wait(timeout=30)
        libs.append(_build.library())

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    n_sources = len([n for n in os.listdir(_build.CSRC_DIR) if n.endswith(".cu")])
    assert (len(compiles), len(links), len(loads)) == (n_sources, 1, 1)
    assert len(libs) == 2 and libs[0] is libs[1]
    assert os.listdir(tmp_path) == [os.path.basename(loads[0])]


# -- dev server ---------------------------------------------------------------


@pytest.fixture
def server():
    ledger = Ledger()
    alice = PrivateKey(seed=2001)
    ledger.genesis_mint(alice.address().to_string(), 10_000_000, n_records=4)
    ct = encryptor.encrypt_private_key_with_secret(alice, "serverpw")
    srv = DevServer(LocalAPIClient(ledger, device=CPU), key_ciphertext=ct,
                    host="127.0.0.1", port=0, device=CPU)
    srv.start()
    yield srv, alice, ledger
    srv.stop()


def _post(srv, route, body):
    url = f"http://127.0.0.1:{srv.port}/testnet3/{route}"
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_server_health(server):
    srv, _alice, _ledger = server
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health") as r:
        assert json.loads(r.read()) == "ok"


def test_server_needs_a_device_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        DevServer(host="127.0.0.1", port=0)
    srv = DevServer(host="127.0.0.1", port=0, device=CPU)
    assert srv.api_client.device == torch.device(CPU)


def test_server_transfer_with_server_key(server):
    srv, alice, ledger = server
    bob = PrivateKey(seed=2002)
    status, tx_id = _post(srv, "transfer", {
        "amount": 250_000, "recipient": bob.address().to_string(),
        "password": "serverpw", "transfer_type": "private",
    })
    assert status == 200 and tx_id.startswith("at1")
    assert _credits(LocalAPIClient(ledger, device=CPU), bob) == [250_000]


def test_server_deploy_and_execute_with_request_key(server):
    srv, alice, _ledger = server
    prog = (
        "program srvtest.aleo;\n\nfunction double:\n"
        "    input r0 as u32.private;\n    add r0 r0 into r1;\n"
        "    output r1 as u32.private;\n"
    )
    status, tx_id = _post(srv, "deploy", {
        "program": prog, "private_key": alice.to_string(),
    })
    assert status == 200 and tx_id.startswith("ad1")
    status, tx_id = _post(srv, "execute", {
        "program_id": "srvtest.aleo", "program_function": "double",
        "inputs": ["21u32"], "private_key": alice.to_string(),
    })
    assert status == 200 and tx_id.startswith("at1")


def test_server_rejects_missing_key(server):
    srv, _alice, _ledger = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "transfer", {"amount": 1, "recipient": "aleo1xyz"})
    assert e.value.code == 400


def test_development_client_roundtrip(server):
    """The port's DevelopmentClient against its dev server over real HTTP."""
    srv, alice, ledger = server
    client = DevelopmentClient(f"http://127.0.0.1:{srv.port}")
    bob = PrivateKey(seed=2077)
    tx = client.transfer(
        100_000, 0, bob.address().to_string(), "private", password="serverpw"
    )
    assert tx.startswith("at1")
    with pytest.raises(DevelopmentClientError):
        client.transfer(1, 0, "aleo1nonsense")  # no key material


# -- F3 in the server -----------------------------------------------------------


def test_server_join_with_fee_spends_three_distinct_records(server):
    srv, alice, ledger = server
    status, tx_id = _post(srv, "join", {"private_key": alice.to_string(), "fee": 100_000})
    assert status == 200
    tx = ledger.transactions[tx_id]
    serials = [sn for t in tx.transitions() for sn in t.serial_numbers]
    assert len(serials) == 3 == len(set(serials))
    assert tx.fee == 100_000 and tx.fee_transition.function == "fee"
    assert [t.function for t in tx.execution.transitions] == ["join"]
    assert _credits(LocalAPIClient(ledger, device=CPU), alice) == \
        [2_400_000, 2_500_000, 5_000_000]


def test_server_split_takes_a_record_below_twice_the_amount(server):
    """Each genesis record holds 2.5M: a split of 2M finds one in the port;
    the JAX server asks for 4M and finds none (F3, kept there)."""
    srv, alice, ledger = server
    body = {"private_key": alice.to_string(), "split_amount": 2_000_000}
    status, tx_id = _post(srv, "split", body)
    assert status == 200 and tx_id.startswith("at1")
    assert _credits(LocalAPIClient(ledger, device=CPU), alice) == \
        [500_000, 2_000_000, 2_500_000, 2_500_000, 2_500_000]
    jledger = JLedger()
    jledger.genesis_mint(JPrivateKey(seed=2001).address().to_string(), 10_000_000,
                         n_records=4)
    with pytest.raises(Exception, match="4000000"):
        JDevServer(JClient(jledger)).handle_split(body)


# -- F6: a block read by its hash -------------------------------------------------


def _get(srv, route):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/testnet3/{route}", timeout=30
    ) as resp:
        return json.loads(resp.read())


def test_server_reads_a_block_by_its_hash(server):
    """block/<hash> answers the block that block/<height> answers, for the
    genesis block and one made by a transfer through the server; the client
    reads it back; an unknown hash is an error; the page's card asks the
    route directly (the JAX page asks find/blockHash, a transaction id's
    route, and then block/None)."""
    srv, _alice, ledger = server
    status, tx_id = _post(srv, "transfer", {
        "amount": 10_000, "recipient": PrivateKey(seed=2003).address().to_string(),
        "password": "serverpw", "transfer_type": "private",
    })
    assert status == 200
    new = next(b for b in ledger.blocks if any(t.id == tx_id for t in b.transactions))
    http = HttpAPIClient(f"http://127.0.0.1:{srv.port}", device=CPU)
    for blk in (ledger.blocks[0], new):
        by_hash = _get(srv, f"block/{blk.hash}")
        assert by_hash == _get(srv, f"block/{blk.height}")
        assert by_hash["hash"] == blk.hash
        assert http.get_block_by_hash(blk.hash) == http.get_block(blk.height)
    assert LocalAPIClient(ledger, device=CPU).get_block_by_hash(new.hash) is new
    assert _get(srv, f"find/blockHash/{tx_id}") == new.hash
    unknown = "ab1" + "0" * 64
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, f"block/{unknown}")
    assert e.value.code == 400
    with pytest.raises(ApiError, match="no block with hash"):
        http.get_block_by_hash(unknown)
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/") as resp:
        page = resp.read().decode()
    card = page.split('title: "Block by hash"')[1].split("title:")[0]
    assert "get(`/testnet3/block/${v.hash}`)" in card and "find/blockHash" not in card
