"""Web-console operation handlers — the L7 browser-tab surface.

Counterpart of the JAX package's `sdk/console.py`, the twin of the
reference website's React tabs (`upstream:website/src/tabs/**`, ~3,500 LoC
over five groups):

  account/   NewAccount, AccountFromPrivateKey, AddressFromViewKey,
             SignMessage, VerifyMessage            (tabs/account/*.jsx)
  advanced/  EncryptAccount, DecryptAccount        (tabs/advanced/*.jsx)
  record/    DecryptRecord                         (tabs/record/DecryptRecord.jsx)
  rest/      GetLatestBlockHeight/Block/ByHash/ByHeight, GetProgram,
             GetTransaction, GetMappingNames/Value (tabs/rest/*.jsx)
  develop/   Execute, Deploy, Transfer, Join, Split (tabs/develop/*.jsx)

The reference runs the account/record group client-side in WASM
(`aleo-wasm-hook.js`) and the develop group in a worker thread pool; here
both run server-side in the DevServer process (the GPU-backed service is
the compute host), and the UI is a single static page
(`aleo_tpu_torch/sdk/website/index.html`) of plain JS fetch() calls — no build
step, served by the DevServer itself at GET /.

Handlers are JSON-dict-in / JSON-dict-out so they are testable without a
socket and reusable from the ProvingWorker protocol.
"""

from __future__ import annotations

from ..program.parser import parse_program
from . import account as acct
from . import encryptor
from .wire import record_ct_from_json

# -- message <-> field encoding ---------------------------------------------
# SignMessage/VerifyMessage sign arbitrary UTF-8 text (tabs/account/
# SignMessage.jsx feeds bytes to wasm Signature::sign). Our Schnorr twin
# signs Fr vectors; pack the bytes little-endian into 31-byte chunks (each
# < 2^248 < r, injective given the trailing length field).


def message_to_fields(message: str) -> list:
    raw = message.encode("utf-8")
    fields = [
        int.from_bytes(raw[i : i + 31], "little") for i in range(0, len(raw), 31)
    ]
    fields.append(len(raw))
    return fields


def signature_to_string(sig: tuple) -> str:
    c, s = sig
    return f"sign1{int(c):064x}{int(s):064x}"


def signature_from_string(text: str) -> tuple:
    assert text.startswith("sign1"), "bad signature prefix"
    body = text[len("sign1") :]
    assert len(body) == 128, "bad signature length"
    return (int(body[:64], 16), int(body[64:128], 16))


# -- account group (tabs/account/*.jsx) -------------------------------------


def new_account(body: dict) -> dict:
    pk = (
        acct.PrivateKey(seed=int(body["seed"]))
        if body.get("seed") is not None
        else acct.PrivateKey()
    )
    return {
        "private_key": pk.to_string(),
        "view_key": pk.view_key().to_string(),
        "address": pk.address().to_string(),
    }


def account_from_private_key(body: dict) -> dict:
    pk = acct.PrivateKey.from_string(body["private_key"])
    return {
        "view_key": pk.view_key().to_string(),
        "address": pk.address().to_string(),
    }


def address_from_view_key(body: dict) -> dict:
    vk = acct.ViewKey.from_string(body["view_key"])
    return {"address": vk.address().to_string()}


def sign_message(body: dict) -> dict:
    pk = acct.PrivateKey.from_string(body["private_key"])
    sig = pk.sign(message_to_fields(body["message"]))
    return {"signature": signature_to_string(sig)}


def verify_message(body: dict) -> dict:
    addr = acct.Address.from_string(body["address"])
    sig = signature_from_string(body["signature"])
    ok = acct.verify(addr, message_to_fields(body["message"]), sig)
    return {"verified": bool(ok)}


# -- advanced group (tabs/advanced/*.jsx) -----------------------------------


def encrypt_account(body: dict) -> dict:
    pk = acct.PrivateKey.from_string(body["private_key"])
    ct = encryptor.encrypt_private_key_with_secret(pk, body["password"])
    return {"ciphertext": ct.to_string()}


def decrypt_account(body: dict) -> dict:
    ct = encryptor.PrivateKeyCiphertext.from_string(body["ciphertext"])
    pk = encryptor.decrypt_private_key_with_secret(ct, body["password"])
    return {
        "private_key": pk.to_string(),
        "view_key": pk.view_key().to_string(),
        "address": pk.address().to_string(),
    }


# -- record group (tabs/record/DecryptRecord.jsx) ---------------------------


class _FetchingRegistry:
    """Program registry over an API client: parse-on-demand so the full
    record decrypt works against both the in-process ledger and a remote
    node (the wasm RecordCiphertext::decrypt needs only the view key; our
    schema-driven entries additionally need the record type layout)."""

    def __init__(self, api_client):
        self.api = api_client
        self._cache: dict = {}

    def get(self, program_id: str):
        if program_id not in self._cache:
            self._cache[program_id] = parse_program(self.api.get_program(program_id))
        return self._cache[program_id]


def decrypt_record(body: dict, api_client) -> dict:
    """Ownership probe + full decrypt (DecryptRecord.jsx:40-76: shows the
    plaintext when the view key owns the ciphertext, an error otherwise)."""
    vk = acct.ViewKey.from_string(body["view_key"])
    ct = record_ct_from_json(body["record"])
    if not ct.is_owner(vk):
        return {"owned": False}
    rec = ct.decrypt(vk, _FetchingRegistry(api_client))
    return {
        "owned": True,
        "record": {
            "program": rec.program,
            "type": rec.type_,
            "owner": acct.field_to_address(rec.owner),
            "gates": str(rec.gates),
            "entries": {k: str(v.data) for k, v in rec.entries.items()},
            "nonce": str(rec.nonce),
        },
    }


# -- dispatch ---------------------------------------------------------------

_PURE = {
    ("account", "new"): new_account,
    ("account", "from_private_key"): account_from_private_key,
    ("account", "address_from_view_key"): address_from_view_key,
    ("account", "sign"): sign_message,
    ("account", "verify"): verify_message,
    ("advanced", "encrypt"): encrypt_account,
    ("advanced", "decrypt"): decrypt_account,
}


def handle(group: str, op: str, body: dict, api_client) -> dict:
    """Route one console POST (`/console/<group>/<op>`)."""
    fn = _PURE.get((group, op))
    if fn is not None:
        return fn(body)
    if (group, op) == ("record", "decrypt"):
        return decrypt_record(body, api_client)
    raise ValueError(f"unknown console operation {group}/{op}")
