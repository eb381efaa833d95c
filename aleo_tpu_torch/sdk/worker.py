"""Message-driven proving worker — the L7 proving-service surface.

Counterpart of the JAX package's `sdk/worker.py`, the twin of the
reference website's web worker (`upstream:website/src/workers/worker.js:
95-658`): the UI thread posts typed messages and never blocks on proving;
the worker owns the ProgramManager/key cache and posts results back. Here
the browser thread pool becomes a daemon thread (the GPU kernels already
parallelize on the device — the `initThreadPool(10)` role of worker.js:36),
and postMessage becomes a pair of queues. `device` (None: CUDA, raising
without it) holds the function keys and runs the proofs.

Message types mirror worker.js's protocol:

  request:  {"type": <ALEO_*>, "id": ..., ...payload}
  response: {"type": <...COMPLETED|ERROR>, "id": ..., ...result}

Supported operations (worker.js handlers :95-658):
  ALEO_EXECUTE_PROGRAM_LOCAL     — run locally, return outputs (no chain)
  ALEO_EXECUTE_PROGRAM_ON_CHAIN  — execute + broadcast, return tx id
  ALEO_ESTIMATE_EXECUTION_FEE    — microcredits estimate
  ALEO_ESTIMATE_DEPLOYMENT_FEE   — microcredits estimate
  ALEO_TRANSFER                  — credits transfer (4 kinds)
  ALEO_DEPLOY                    — deploy a program
  ALEO_SPLIT / ALEO_JOIN         — record management

ALEO_JOIN with a fee takes its three records in one search and ALEO_SPLIT
looks for a record of at least the split amount, as the port's dev server
does (`dev_server.join_records`); the JAX package's worker can spend one
record twice in a join and asks a split for twice its amount.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Optional

from ..fields import limbs
from . import account as acct
from .api_client import LocalAPIClient
from .dev_server import _TRANSFER_TYPES, _parse_inputs, join_records
from .ledger import Ledger
from .program_manager import ProgramManager


class ProvingWorker:
    """Background proving service over a pair of message queues."""

    def __init__(self, api_client=None, prove: bool = False, device=None):
        self.device = limbs.resolve_device(device)
        if api_client is None:
            api_client = LocalAPIClient(Ledger(), device=self.device)
        self.api_client = api_client
        self.prove = prove
        self.requests: "queue.Queue[dict]" = queue.Queue()
        self.responses: "queue.Queue[dict]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ProvingWorker":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.requests.put({"type": "__STOP__"})
        if self._thread:
            self._thread.join(timeout=30)

    def post_message(self, msg: dict) -> None:
        """postMessage twin: enqueue a request, never blocks on proving."""
        self.requests.put(msg)

    def get_response(self, timeout: Optional[float] = None) -> dict:
        return self.responses.get(timeout=timeout)

    def call(self, msg: dict, timeout: float = 600.0) -> dict:
        """Convenience synchronous round trip (tests / CLI use)."""
        self.post_message(msg)
        resp = self.get_response(timeout=timeout)
        if resp["type"] == "ERROR":
            raise RuntimeError(resp["error"])
        return resp

    # -- worker loop ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            msg = self.requests.get()
            mtype = msg.get("type")
            if mtype == "__STOP__":
                return
            try:
                result = self._dispatch(mtype, msg)
                result.setdefault("id", msg.get("id"))
                self.responses.put(result)
            except Exception as e:  # typed error surface back to the poster
                self.responses.put({
                    "type": "ERROR",
                    "id": msg.get("id"),
                    "error": str(e),
                    "trace": traceback.format_exc(),
                })

    def _manager(self, msg) -> ProgramManager:
        pk = acct.PrivateKey.from_string(msg["privateKey"])
        return ProgramManager(self.api_client, private_key=pk, device=self.device)

    def _dispatch(self, mtype: str, msg: dict) -> dict:
        if mtype == "ALEO_EXECUTE_PROGRAM_LOCAL":
            # run the function locally, no proof, no broadcast
            # (worker.js:95-130 executeProgramLocal)
            from ..program.interpreter import Interpreter
            from ..program.parser import parse_program

            prog = parse_program(msg["localProgram"])
            reg = self._manager(msg).registry
            reg.add(prog)
            tr = Interpreter(reg).execute(
                prog.id, msg["aleoFunction"],
                _parse_inputs(msg.get("inputs", [])),
                caller=acct.PrivateKey.from_string(
                    msg["privateKey"]
                ).address().x,
            )
            return {
                "type": "OFFLINE_EXECUTION_COMPLETED",
                "outputs": [str(o.data) for o in tr.outputs],
            }
        if mtype == "ALEO_EXECUTE_PROGRAM_ON_CHAIN":
            pm = self._manager(msg)
            if "remoteProgram" in msg:
                pm.add_program(msg["remoteProgram"])
            tx = pm.execute_program(
                msg["remoteProgram_id"] if "remoteProgram_id" in msg
                else msg["programId"],
                msg["aleoFunction"],
                _parse_inputs(msg.get("inputs", [])),
                fee=int(msg.get("fee", 0)),
                prove=self.prove,
            )
            return {"type": "EXECUTION_TRANSACTION_COMPLETED", "transaction": tx}
        if mtype == "ALEO_ESTIMATE_EXECUTION_FEE":
            pm = self._manager(msg)
            if "remoteProgram" in msg:
                pm.add_program(msg["remoteProgram"])
            fee = pm.estimate_execution_fee(
                msg["programId"], msg["aleoFunction"],
                _parse_inputs(msg.get("inputs", [])),
            )
            return {"type": "EXECUTION_FEE_ESTIMATION_COMPLETED",
                    "executionFee": fee}
        if mtype == "ALEO_ESTIMATE_DEPLOYMENT_FEE":
            pm = self._manager(msg)
            fee = pm.estimate_deployment_fee(msg["program"])
            return {"type": "DEPLOYMENT_FEE_ESTIMATION_COMPLETED",
                    "deploymentFee": fee}
        if mtype == "ALEO_TRANSFER":
            pm = self._manager(msg)
            tx = pm.transfer(
                int(msg["amountCredits"]),
                int(msg.get("fee", 0)),
                msg["recipient"],
                _TRANSFER_TYPES[msg.get("transfer_type", "private")],
                prove=self.prove,
            )
            return {"type": "TRANSFER_TRANSACTION_COMPLETED", "transaction": tx}
        if mtype == "ALEO_DEPLOY":
            pm = self._manager(msg)
            tx = pm.deploy_program(
                msg["program"], fee=int(msg.get("fee", 0)), prove=self.prove
            )
            return {"type": "DEPLOY_TRANSACTION_COMPLETED", "transaction": tx}
        if mtype == "ALEO_SPLIT":
            pm = self._manager(msg)
            pk = acct.PrivateKey.from_string(msg["privateKey"])
            rec = pm.record_finder.find_one_record(pk, int(msg["splitAmount"]))
            tx = pm.split(rec, int(msg["splitAmount"]), prove=self.prove)
            return {"type": "SPLIT_TRANSACTION_COMPLETED", "transaction": tx}
        if mtype == "ALEO_JOIN":
            pm = self._manager(msg)
            pk = acct.PrivateKey.from_string(msg["privateKey"])
            fee = int(msg.get("fee", 0))
            one, two, fee_record = join_records(pm, pk, fee)
            tx = pm.join(one, two, fee=fee, fee_record=fee_record, prove=self.prove)
            return {"type": "JOIN_TRANSACTION_COMPLETED", "transaction": tx}
        raise ValueError(f"unknown message type {mtype!r}")
