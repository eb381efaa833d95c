"""Development server — REST endpoints that prove server-side.

Counterpart of the JAX package's `sdk/dev_server.py`, the twin of
`aleo-development-server` (`upstream:rust/develop/src/{lib,routes,requests}.rs`):

  POST /testnet3/deploy    {program, private_key | password, fee, fee_record?}
  POST /testnet3/execute   {program_id, program_function, inputs, private_key
                            | password, fee, fee_record?}
  POST /testnet3/transfer  {amount, fee, recipient, transfer_type,
                            private_key | password, fee_record?, amount_record?}
  POST /testnet3/join      {private_key | password, fee}
  POST /testnet3/split     {private_key | password, split_amount}
  GET  /health

plus the browser-console surface (the reference website's role — see
`aleo_tpu_torch/sdk/console.py`): GET / serves the static single-page console
and POST /console/<group>/<op> routes its account/record/advanced
operations.

Like the reference (lib.rs:171-221), the server can hold a private-key
ciphertext at startup; per-request keys/passwords override it
(routes.rs:61-80). Body limit 16 MB (routes.rs:25). Backed by a
ProgramManager over any API client (an in-process ledger by default).
`device` (None: CUDA, raising without it) is the device of every
ProgramManager the server makes: it holds the function keys and runs the
proofs.

Built on the stdlib ThreadingHTTPServer; proving runs on the handler thread
(the `spawn_blocking!` role, helpers/macros.rs:18-23).

A join with a fee takes its three records (the two joined and the fee's) in
one `find_record_amounts` call, so they are distinct, and a split looks for
one record of at least the split amount. The JAX package's server takes the
fee record in a second search, which can return one of the joined two, and
asks a split for twice its amount.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import config
from ..fields import limbs
from ..program.values import Value
from . import account as acct
from . import encryptor
from .api_client import LocalAPIClient
from .ledger import Ledger
from .program_manager import ProgramManager, TransferType

MAX_BODY = 16 * 1024 * 1024  # routes.rs:25

_TRANSFER_TYPES = {
    "private": TransferType.Private,
    "public": TransferType.Public,
    "private_to_public": TransferType.PrivateToPublic,
    "public_to_private": TransferType.PublicToPrivate,
    # reference TransferTypeArg spellings (cli/helpers/serialize.rs:41-61)
    "transfer_private": TransferType.Private,
    "transfer_public": TransferType.Public,
}


def _parse_inputs(raw):
    out = []
    for item in raw:
        # "5u32" / "true" / "aleo1..." / {"type": ..., "value": ...}
        if isinstance(item, dict):
            out.append(Value(item["type"], item["value"]))
            continue
        s = str(item)
        if s in ("true", "false"):
            out.append(Value("boolean", s == "true"))
        elif s.startswith("aleo1"):
            out.append(Value("address", acct.address_to_field(s)))
        elif s.endswith("field"):
            out.append(Value("field", int(s[: -len("field")])))
        else:
            for w in ("u8", "u16", "u32", "u64", "u128", "i8", "i16", "i32", "i64", "i128"):
                if s.endswith(w):
                    out.append(Value(w, int(s[: -len(w)])))
                    break
            else:
                raise ValueError(f"cannot parse input {s!r}")
    return out


def join_records(pm: ProgramManager, pk: acct.PrivateKey, fee: int) -> tuple:
    """(record one, record two, fee record or None) for a join: with a fee,
    three distinct records from one search. `find_record_amounts` returns
    its records in the order of the amounts sorted descending, so the
    amounts are asked for in that order (the fee, at least 1, first) and
    each record is the one of its amount."""
    if fee <= 0:
        one, two = pm.record_finder.find_record_amounts([1, 1], pk)
        return one, two, None
    fee_record, one, two = pm.record_finder.find_record_amounts([fee, 1, 1], pk)
    return one, two, fee_record


class DevServer:
    """`Rest::initialize` twin (lib.rs:185-221)."""

    def __init__(
        self,
        api_client=None,
        key_ciphertext: Optional[encryptor.PrivateKeyCiphertext] = None,
        host: str = config.SERVER_HOST,
        port: int = config.SERVER_PORT,
        prove: bool = False,
        device=None,
    ):
        self.device = limbs.resolve_device(device)
        if api_client is None:
            api_client = LocalAPIClient(Ledger(), device=self.device)
        self.api_client = api_client
        self.key_ciphertext = key_ciphertext
        self.host, self.port = host, port
        self.prove = prove
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- key resolution (routes.rs:61-80) ------------------------------------

    def _resolve_manager(self, body) -> tuple:
        pk_str = body.get("private_key")
        password = body.get("password")
        if pk_str:
            pk = acct.PrivateKey.from_string(pk_str)
            return ProgramManager(
                self.api_client, private_key=pk, device=self.device
            ), None
        if self.key_ciphertext is not None and password is not None:
            pm = ProgramManager(
                self.api_client, private_key_ciphertext=self.key_ciphertext,
                device=self.device,
            )
            return pm, password
        raise ValueError("either private_key or (server ciphertext + password) required")

    # -- handlers ------------------------------------------------------------

    def handle_deploy(self, body) -> str:
        pm, password = self._resolve_manager(body)
        return pm.deploy_program(
            body["program"], fee=int(body.get("fee", 0)),
            password=password, prove=self.prove,
        )

    def handle_execute(self, body) -> str:
        pm, password = self._resolve_manager(body)
        return pm.execute_program(
            body["program_id"],
            body["program_function"],
            _parse_inputs(body.get("inputs", [])),
            fee=int(body.get("fee", 0)),
            password=password,
            prove=self.prove,
        )

    def handle_transfer(self, body) -> str:
        pm, password = self._resolve_manager(body)
        ttype = _TRANSFER_TYPES[body.get("transfer_type", "private")]
        return pm.transfer(
            int(body["amount"]),
            int(body.get("fee", 0)),
            body["recipient"],
            ttype,
            password=password,
            prove=self.prove,
        )

    def handle_join(self, body) -> str:
        """Join two unspent credits records (tabs/develop/Join.jsx; the
        worker's ALEO_JOIN message picks the records server-side)."""
        pm, password = self._resolve_manager(body)
        pk = pm.get_private_key(password)
        fee = int(body.get("fee", 0))
        one, two, fee_record = join_records(pm, pk, fee)
        return pm.join(
            one, two, fee=fee, fee_record=fee_record,
            password=password, prove=self.prove,
        )

    def handle_split(self, body) -> str:
        """Split an unspent credits record (tabs/develop/Split.jsx)."""
        pm, password = self._resolve_manager(body)
        pk = pm.get_private_key(password)
        amount = int(body["split_amount"])
        rec = pm.record_finder.find_one_record(pk, amount)
        return pm.split(rec, amount, password=password, prove=self.prove)

    # -- node REST surface (GET; blocking.rs:23-178 paths) -------------------

    def handle_node_get(self, path: str):
        """Serve the node REST GET endpoints over the backing API client so
        `HttpAPIClient` reaches full 19-endpoint parity against this server
        (the reference's node surface, `upstream:rust/src/api/
        blocking.rs:23-356`; paths mirror `{network}/...`)."""
        from urllib.parse import urlparse, parse_qs

        from . import wire

        u = urlparse(path)
        parts = [p for p in u.path.split("/") if p]
        if not parts:
            return False, None
        # strip the network prefix ("testnet3")
        if parts[0] == getattr(self.api_client, "network", "testnet3"):
            parts = parts[1:]
        api = self.api_client
        if parts == ["latest", "height"]:
            return True, api.latest_height()
        if parts == ["latest", "hash"]:
            return True, api.latest_hash()
        if parts == ["latest", "block"]:
            return True, wire.block_to_json(api.latest_block())
        if parts == ["latest", "stateRoot"]:
            return True, api.get_state_root()
        if len(parts) == 2 and parts[0] == "block":
            # a height (digits) or a block hash ("ab1" + hex), as the node's
            # block/{height_or_hash}
            blk = (api.get_block(int(parts[1])) if parts[1].isdecimal()
                   else api.get_block_by_hash(parts[1]))
            return True, wire.block_to_json(blk)
        if parts == ["blocks"]:
            q = parse_qs(u.query)
            start = int(q["start"][0])
            end = int(q["end"][0])
            return True, [wire.block_to_json(b) for b in api.get_blocks(start, end)]
        if len(parts) == 2 and parts[0] == "transaction":
            return True, wire.transaction_to_json(api.get_transaction(parts[1]))
        if parts == ["memoryPool", "transactions"]:
            return True, [
                wire.transaction_to_json(t)
                for t in api.get_memory_pool_transactions()
            ]
        if len(parts) == 2 and parts[0] == "statePath":
            root, mpath = api.get_state_path(int(parts[1]))
            return True, {
                "root": str(root),
                "path": [[str(s), int(side)] for (s, side) in mpath],
            }
        if len(parts) >= 2 and parts[0] == "program":
            if len(parts) == 2:
                return True, api.get_program(parts[1])
            if parts[2] == "mappings":
                return True, api.get_program_mappings(parts[1])
            if parts[2] == "import_resolution":
                return True, api.get_program_imports(parts[1])
            if parts[2] == "mapping" and len(parts) == 5:
                v = api.get_mapping_value(parts[1], parts[3], int(parts[4]))
                return True, None if v is None else str(v)
        if len(parts) == 3 and parts[:2] == ["find", "blockHash"]:
            return True, api.find_block_hash(parts[2])
        if len(parts) == 3 and parts[:2] == ["find", "transitionID"]:
            return True, api.find_transition_id(int(parts[2]))
        return False, None

    def handle_broadcast(self, body) -> str:
        from . import wire

        tx = wire.transaction_from_json(body)
        return self.api_client.transaction_broadcast(tx)

    # -- server lifecycle ----------------------------------------------------

    def start(self, background: bool = True):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # access log (lib.rs:248-251)
                pass

            def _reply(self, code: int, payload):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")  # CORS
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path.rstrip("/") == "/health":
                    self._reply(200, "ok")
                    return
                if self.path.rstrip("/") in ("", "/console"):
                    import pathlib

                    page = (
                        pathlib.Path(__file__).parent / "website" / "index.html"
                    ).read_bytes()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)
                    return
                try:
                    handled, payload = server.handle_node_get(self.path)
                except Exception as e:
                    self._reply(400, {"error": str(e)})
                    return
                if handled:
                    self._reply(200, payload)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY:
                    self._reply(413, {"error": "body too large"})
                    return
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    parts = [p for p in self.path.split("/") if p]
                    if len(parts) == 3 and parts[0] == "console":
                        from . import console

                        self._reply(
                            200,
                            console.handle(
                                parts[1], parts[2], body, server.api_client
                            ),
                        )
                        return
                    route = parts[-1] if parts else ""
                    if route == "deploy":
                        self._reply(200, server.handle_deploy(body))
                    elif route == "execute":
                        self._reply(200, server.handle_execute(body))
                    elif route == "transfer":
                        self._reply(200, server.handle_transfer(body))
                    elif route == "join":
                        self._reply(200, server.handle_join(body))
                    elif route == "split":
                        self._reply(200, server.handle_split(body))
                    elif route == "broadcast":
                        self._reply(200, server.handle_broadcast(body))
                    else:
                        self._reply(404, {"error": f"unknown route {route}"})
                except Exception as e:  # typed error surface (error.rs)
                    self._reply(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True
            )
            self._thread.start()
        else:
            self._httpd.serve_forever()

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
