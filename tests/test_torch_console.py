"""The port's browser console (`aleo_tpu_torch.sdk.console` and the page
`sdk/website/index.html`) on the CPU, served end to end by the port's
DevServer over real HTTP, against the JAX package's console.

The cases of tests/test_console.py on the port (`device="cpu"`). The
replies that do not depend on fresh randomness are held against the JAX
package's `console.handle` given the same bodies, tolerance 0: a seeded
account, its derivations, a signature and its verification, the decryption
of a ciphertext from either package (encryption draws a fresh nonce), and a
record decryption.
"""

import json
import pathlib
import urllib.request

import pytest

from aleo_tpu.sdk import console as jconsole
from aleo_tpu.sdk.api_client import LocalAPIClient as JClient
from aleo_tpu.sdk.ledger import Ledger as JLedger
from aleo_tpu_torch.sdk import wire
from aleo_tpu_torch.sdk.account import PrivateKey
from aleo_tpu_torch.sdk.api_client import HttpAPIClient, LocalAPIClient
from aleo_tpu_torch.sdk.dev_server import DevServer
from aleo_tpu_torch.sdk.ledger import Ledger

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def server():
    ledger = Ledger()
    alice = PrivateKey(seed=5001)
    ledger.genesis_mint(alice.address().to_string(), 10_000_000, n_records=4)
    srv = DevServer(LocalAPIClient(ledger, device=CPU), host="127.0.0.1", port=0,
                    device=CPU)
    srv.start(background=True)
    yield f"http://127.0.0.1:{srv.port}", alice
    srv.stop()


@pytest.fixture(scope="module")
def jclient():
    ledger = JLedger()
    ledger.genesis_mint(PrivateKey(seed=5001).address().to_string(), 10_000_000,
                        n_records=4)
    return JClient(ledger)


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def _same_as_jax(base, group, op, body, jclient=None):
    """The port's reply over HTTP, equal to the JAX handler's on the body."""
    got = _post(base, f"/console/{group}/{op}", body)
    assert got == json.loads(json.dumps(jconsole.handle(group, op, body, jclient)))
    return got


def test_console_page_served(server):
    base, _ = server
    with urllib.request.urlopen(base + "/") as resp:
        page = resp.read().decode()
        assert resp.headers["Content-Type"].startswith("text/html")
    # all five tab groups of the reference website are present (the GROUPS
    # object literal; section ids are mounted by JS at runtime)
    for group in ("account", "record", "advanced", "rest", "develop"):
        assert f"{group}: [" in page
    for title in (
        "New account", "Sign message", "Decrypt record", "Encrypt account",
        "Latest block height", "Mapping value", "Execute", "Split record",
    ):
        assert title in page
    # the JAX package's page, but for the comment lines on the sources and on
    # where the compute runs, and the "Block by hash" card, which asks the
    # block route with the hash (F6 repaired; the JAX card asks find/blockHash)
    jax_page = (ROOT / "aleo_tpu" / "sdk" / "website" / "index.html").read_text()
    assert "GPU" in page and "TPU-side compute" in jax_page
    lines, jax_lines = page.splitlines(), jax_page.splitlines()
    assert [ln for ln in lines if ln not in jax_lines] == [
        "  (upstream:website/src: App.jsx routing + tabs/{account,record,",
        "  /console/* + /testnet3/* routes (the compute runs on the server's GPU",
        "  instead of in WASM).",
        "      run: v => get(`/testnet3/block/${v.hash}`) },",
    ]


def test_account_group_matches_jax(server):
    base, _ = server
    acc = _same_as_jax(base, "account", "new", {"seed": 7100})
    assert acc["private_key"].startswith("aprivatekey1")
    assert acc["view_key"].startswith("aviewkey1")
    assert acc["address"].startswith("aleo1")
    derived = _same_as_jax(base, "account", "from_private_key",
                           {"private_key": acc["private_key"]})
    assert derived == {"view_key": acc["view_key"], "address": acc["address"]}
    addr = _same_as_jax(base, "account", "address_from_view_key",
                        {"view_key": acc["view_key"]})
    assert addr == {"address": acc["address"]}


def test_sign_verify_roundtrip_matches_jax(server):
    base, _ = server
    acc = _post(base, "/console/account/new", {"seed": 7200})
    msg = "hello from the gpu console — 31+ bytes of utf-8 text"
    sig = _same_as_jax(base, "account", "sign",
                       {"private_key": acc["private_key"], "message": msg})["signature"]
    assert sig.startswith("sign1")
    ok = _same_as_jax(base, "account", "verify",
                      {"address": acc["address"], "message": msg, "signature": sig})
    assert ok == {"verified": True}
    bad = _same_as_jax(base, "account", "verify",
                       {"address": acc["address"], "message": msg + "!", "signature": sig})
    assert bad == {"verified": False}


def test_advanced_encrypt_decrypt_matches_jax(server):
    base, _ = server
    acc = _post(base, "/console/account/new", {"seed": 7300})
    ct = _post(base, "/console/advanced/encrypt",
               {"private_key": acc["private_key"], "password": "s3cret"})["ciphertext"]
    assert ct.startswith("ciphertext1")
    jct = jconsole.handle("advanced", "encrypt",
                          {"private_key": acc["private_key"], "password": "s3cret"},
                          None)["ciphertext"]
    for c in (ct, jct):
        back = _same_as_jax(base, "advanced", "decrypt",
                            {"ciphertext": c, "password": "s3cret"})
        assert back == acc
    with pytest.raises(Exception):
        _post(base, "/console/advanced/decrypt",
              {"ciphertext": ct, "password": "wrong"})


def test_record_decrypt_matches_jax(server, jclient):
    base, alice = server
    client = HttpAPIClient(base, device=CPU)
    cts = client.scan(alice.view_key(), 0, client.latest_height() + 1)
    assert cts
    body = {
        "view_key": alice.view_key().to_string(),
        "record": wire.record_ct_to_json(cts[0]),
    }
    out = _same_as_jax(base, "record", "decrypt", body, jclient)
    assert out["owned"] is True
    rec = out["record"]
    assert rec["program"] == "credits.aleo"
    assert rec["owner"] == alice.address().to_string()
    assert int(rec["entries"]["microcredits"]) == 2_500_000
    other = PrivateKey(seed=7400)
    body["view_key"] = other.view_key().to_string()
    assert _same_as_jax(base, "record", "decrypt", body, jclient) == {"owned": False}
    with pytest.raises(Exception):
        _post(base, "/console/record/nothing", body)


def test_develop_join_split(server):
    base, alice = server
    pk = alice.to_string()
    tx1 = _post(base, "/testnet3/split",
                {"private_key": pk, "split_amount": 500_000})
    assert tx1.startswith("at1")
    tx2 = _post(base, "/testnet3/join", {"private_key": pk, "fee": 0})
    assert tx2.startswith("at1")
