"""Batches of credits.aleo transitions proven back to back (a closed loop), as
a delegated proving service works through its backlog.

Set-up: the SRS (from `proofbench/_cache/`, generated on a cold checkout),
the function's keys synthesized over it, the benchmark's own copy of the
program. A step: host synthesis of the k transitions of the step, one
`snark.batch.prove_batch` over them, each proof serialized to bytes. The
outputs kept for the comparison are each transition's description with its
proof's bytes; the first circuit's constraint matrices are kept too, for the
reference's verifying key.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

import torch

from .. import checks
from ..inputs import credits as credit_inputs
from ..inputs import srs as srs_inputs
from ..reference import curve, marlin, transitions

UNIT = "proofs"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device, spans):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.function = traffic["function"]
        self.k = traffic["k"]
        self.outputs: List = []
        self.matrices = None
        self.srs_seed = config["srs_seed"].encode()
        self.fault = None           # tests and the control plant faults here

    # -- set-up --------------------------------------------------------------

    def setup(self) -> Dict:
        from aleo_tpu_torch.pcs.srs import srs_from_numpy
        from aleo_tpu_torch.program.interpreter import Registry
        from aleo_tpu_torch.program.parser import parse_program
        from aleo_tpu_torch.snark import pipeline

        blob, srs_s = srs_inputs.load(self.config["srs_max_degree"], self.srs_seed)
        self.srs = srs_from_numpy(blob, device=self.device)
        with open(os.path.join(ROOT, self.config["program_file"])) as f:
            source = f.read()
        self.registry = Registry()
        self.registry.add(parse_program(source))
        self.keys = pipeline.synthesize_keys(
            self.registry, self.config["program"], self.function, srs=self.srs, cache=False)
        want = self.config["functions"][self.function]
        idx = self.keys.index
        got = {"n": idx.n, "m": idx.m, "ell": idx.ell}
        if got != want:
            raise RuntimeError(f"{self.function}: the keys' domains {got} are not {want}")
        return {"srs_generated_s": srs_s}

    # -- one step ------------------------------------------------------------

    def _program_inputs(self, t: Dict):
        from aleo_tpu_torch.program.values import Record, Value

        if self.function == "transfer_public":
            return [Value("address", t["receiver"]), Value("u64", t["amount"])]
        record = Record(self.config["program"], "credits", owner=t["owner"], gates=0,
                        entries={"microcredits": Value("u64", t["microcredits"])},
                        nonce=t["nonce"])
        return [record, Value("address", t["receiver"]), Value("u64", t["amount"])]

    def step(self, index: int) -> int:
        from aleo_tpu_torch.snark import batch, pipeline
        from aleo_tpu_torch.snark.serialize import proof_to_bytes

        ts = credit_inputs.transitions(self.seed, index, self.k, self.traffic)
        cs_list = []
        for t in ts:
            nonces = iter(t["out_nonces"])
            with self.spans.span("synthesize"):
                syn = pipeline.synthesize_and_check(
                    self.keys, self.registry, self._program_inputs(t), t["owner"],
                    lambda: next(nonces))
            cs_list.append(syn.cs)
        if self.fault == "witness":
            for cs in cs_list:
                cs.assignments[-1] = (cs.assignments[-1] + 1) % marlin.R
        if self.matrices is None:
            cs = cs_list[0]
            self.matrices = (cs.matrices(), cs.num_inputs, cs.num_constraints, cs.num_variables)
        rng = random.Random(f"masks/{self.seed}/{index}")
        with self.spans.span("prove_batch"):
            proofs = batch.prove_batch(self.keys.index, cs_list, rng=rng)
        idx = self.keys.index
        with self.spans.span("serialize"):
            blobs = [proof_to_bytes(p, idx.n, idx.m, idx.ell) for p in proofs]
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.outputs.append((ts, blobs))
        return len(blobs)

    def free(self) -> None:
        for name in ("keys", "srs", "registry"):
            setattr(self, name, None)

    # -- the comparison ------------------------------------------------------

    def judge(self) -> List[checks.Check]:
        tau = srs_inputs.trapdoor(self.srs_seed)
        mats, n_in, n_cons, n_vars = self.matrices
        vk = marlin.index_key(mats, n_in, n_cons, n_vars, tau, self.config["srs_max_degree"])
        with open(os.path.join(ROOT, self.config["verifying_keys"])) as f:
            want = json.load(f)[self.function]
        got = [curve.to_bytes(p).hex() for p in vk.index_commitments]
        vk_diff = sum(a != b for a, b in zip(got, want["index_commitments"]))
        vk_diff += abs(len(got) - len(want["index_commitments"]))
        vk_diff += int((vk.n, vk.m, vk.ell) != (want["n"], want["m"], want["ell"]))
        attempted = rejected = 0
        first = ""
        seen = set()
        repeated = 0
        for ts, blobs in self.outputs:
            repeated += sum(b in seen for b in blobs)
            seen.update(blobs)
            attempted += len(ts)
            rejected += max(0, len(ts) - len(blobs))
            for t, blob in zip(ts, blobs):
                try:
                    why = marlin.verify(vk, transitions.public_inputs(self.function, t),
                                        marlin.parse_proof(blob))
                except ValueError as exc:
                    why = f"unreadable: {exc}"
                if why:
                    rejected += 1
                    first = first or why
        return [
            checks.Check("vk_commitments_differing", vk_diff, 0,
                         "the reference's key against the JAX package's"),
            checks.Check("proofs_rejected", rejected, 0,
                         first or "every proof verifies", attempted=attempted),
            checks.Check("proofs_repeated", repeated, 0,
                         "a proof's bytes equal to an earlier one's: its masks were not fresh"),
        ]
