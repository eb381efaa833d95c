"""DevelopmentClient — typed client for the development server.

Counterpart of the JAX package's `sdk/development_client.py`, the twin of
the JS SDK's `DevelopmentClient` (`upstream:sdk/src/development_client.ts:
38-200`): thin request wrappers for the dev server's three POST endpoints,
with the same request models (`upstream:rust/develop/src/requests.rs:23-58`).
Standard-library HTTP only, no tensor: works against the port's
`sdk.dev_server.DevServer` or any server exposing the same routes.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import List, Optional


class DevelopmentClientError(Exception):
    pass


class DevelopmentClient:
    def __init__(self, base_url: str, network: str = "testnet3", timeout: int = 600):
        self.base_url = base_url.rstrip("/")
        self.network = network
        self.timeout = timeout

    def _post(self, route: str, body: dict) -> str:
        url = f"{self.base_url}/{self.network}/{route}"
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:
                detail = ""
            raise DevelopmentClientError(f"{route} failed ({e.code}): {detail}")

    def deploy_program(
        self,
        program: str,
        fee: int = 0,
        private_key: Optional[str] = None,
        password: Optional[str] = None,
        fee_record: Optional[str] = None,
    ) -> str:
        """POST /deploy (development_client.ts deployProgram twin)."""
        return self._post("deploy", _drop_none({
            "program": program, "fee": fee, "private_key": private_key,
            "password": password, "fee_record": fee_record,
        }))

    def execute_program(
        self,
        program_id: str,
        program_function: str,
        inputs: List[str],
        fee: int = 0,
        private_key: Optional[str] = None,
        password: Optional[str] = None,
        fee_record: Optional[str] = None,
    ) -> str:
        """POST /execute (development_client.ts executeProgram twin)."""
        return self._post("execute", _drop_none({
            "program_id": program_id, "program_function": program_function,
            "inputs": inputs, "fee": fee, "private_key": private_key,
            "password": password, "fee_record": fee_record,
        }))

    def transfer(
        self,
        amount: int,
        fee: int,
        recipient: str,
        transfer_type: str = "private",
        private_key: Optional[str] = None,
        password: Optional[str] = None,
        fee_record: Optional[str] = None,
        amount_record: Optional[str] = None,
    ) -> str:
        """POST /transfer (development_client.ts transfer twin)."""
        return self._post("transfer", _drop_none({
            "amount": amount, "fee": fee, "recipient": recipient,
            "transfer_type": transfer_type, "private_key": private_key,
            "password": password, "fee_record": fee_record,
            "amount_record": amount_record,
        }))


def _drop_none(d: dict) -> dict:
    return {k: v for k, v in d.items() if v is not None}
