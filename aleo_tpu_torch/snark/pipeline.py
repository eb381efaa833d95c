"""Execution proving pipeline: Aleo program function -> keys -> proof.

Counterpart of the JAX package's `snark/pipeline.py`. It connects the circuit
synthesizer (`program/synthesizer.py`) to the Marlin indexer/prover/verifier
(`snark/`), mirroring snarkVM's two flows:

  * key synthesis at deployment: a ProvingKey/VerifyingKey per function from
    the circuit *structure* (burner inputs);
  * proving at execution: synthesize the circuit with the real inputs and run
    the prover over the indexed matrices (`Trace::prove_execution`).

The circuit structure (constraint rows and coefficients) for a fixed function
signature is input-independent, so an `Index` built from burner inputs proves
any concrete execution of that function.

Keys live on a device: `synthesize_keys(..., device=None)` means the GPU and
raises without one. `keys_from_numpy` takes the key blob and the SRS blob of
either package (the layouts are the same) onto a device.
"""

from __future__ import annotations

import hashlib
import os
import pickle

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import params
from ..fields import limbs
from ..pcs.srs import Srs, srs_from_numpy
from ..program.interpreter import Registry, Transition
from ..program.parser import Program
from ..program.synthesizer import Synthesis, synthesize_execution
from ..program.values import Record, Value
from .indexer import Index, MatrixIndex, index_r1cs
from .prover import Proof, prove
from .sparse import SparseTables
from .verifier import VerifyingKey, verify
from ..utils import profiling as prof

R = params.R

INT_DEFAULTS = {
    "u8": 0, "u16": 0, "u32": 0, "u64": 0, "u128": 0,
    "i8": 0, "i16": 0, "i32": 0, "i64": 0, "i128": 0,
}


def burner_inputs(prog: Program, function: str) -> List:
    """Structure-only inputs for key synthesis (snarkVM's burner inputs).

    Values are arbitrary; only the type shapes matter for the circuit.
    """
    fn = prog.functions[function]
    out = []
    for decl in fn.inputs:
        out.append(_burner_value(prog, decl.type_, decl.visibility))
    return out


def _burner_value(prog: Program, type_: str, vis: str):
    if vis == "record" or type_ in prog.records:
        rt = prog.records[type_.split(".")[-1] if "." in type_ else type_]
        entries = {}
        for (name, base, _v) in rt.fields:
            if name in ("owner", "gates"):
                continue
            entries[name] = _burner_value(prog, base, "private")
        return Record(prog.id, rt.name, owner=1, gates=0, entries=entries, nonce=1)
    if type_ in prog.structs:
        st = prog.structs[type_]
        return Value(type_, {n: _burner_value(prog, t, "private") for n, t in st.fields})
    if type_ == "boolean":
        return Value("boolean", False)
    if type_ in INT_DEFAULTS:
        return Value(type_, 0)
    # field / group / scalar / address
    return Value(type_, 1)


@dataclass
class FunctionKeys:
    """Per-function proving/verifying key pair (snarkVM ProvingKey/VerifyingKey
    twin)."""

    program_id: str
    function: str
    index: Index            # proving key: committed index polys + spmv tables
    vk: VerifyingKey
    constraint_counts: Dict[str, int]


@dataclass
class ExecutionProof:
    """A proven transition (the payload of snarkVM's `OfflineExecution`)."""

    program_id: str
    function: str
    public_inputs: List[int]
    proof: Proof
    transition: Transition


from ..config import KEY_DIR as _KEY_CACHE_DIR

# Bump when circuit semantics change (synthesizer gadgets, Poseidon
# parameterization, variable layout): part of the key-cache digest.
CIRCUIT_FORMAT_VERSION = "r5-arkworks-poseidon-1"


def synthesize_keys(
    registry: Registry,
    program_id: str,
    function: str,
    srs=None,
    inputs: Optional[List] = None,
    cache: bool = True,
    device=None,
) -> FunctionKeys:
    """Deploy-time key synthesis for one function (`Process::synthesize_key`).

    Results are cached on disk per (program source, function): the role of
    snarkVM's proving-key files. Pass cache=False for a fresh synthesis.
    device=None means the GPU (with an `srs` given, the device it lies on).
    """
    device = srs.device if srs is not None and device is None else limbs.resolve_device(device)
    prog = registry.get(program_id)
    cache_path = None
    if cache and srs is None:
        # the digest pins everything the circuit shape depends on: program
        # source, function, and the synthesizer/hash parameterization
        digest = hashlib.sha256(
            (prog.source + "\x00" + function + "\x00" + CIRCUIT_FORMAT_VERSION)
            .encode()
        ).hexdigest()[:20]
        cache_path = os.path.join(_KEY_CACHE_DIR, f"{prog.name}_{function}_{digest}.pkl")
        if os.path.exists(cache_path):
            try:
                return _load_keys(cache_path, device)
            except (OSError, KeyError, pickle.UnpicklingError, EOFError):
                pass  # stale/corrupt cache: resynthesize
    if inputs is None:
        inputs = burner_inputs(prog, function)
    with prof.stage("pipeline/synthesize_keys"):
        syn = synthesize_execution(
            registry, program_id, function, inputs, caller=1, rng_nonce=lambda: 1
        )
    with prof.stage("pipeline/index"):
        index = index_r1cs(syn.cs, srs=srs, device=device)
    keys = FunctionKeys(
        program_id, function, index, VerifyingKey.from_index(index),
        syn.constraint_counts,
    )
    if cache_path is not None:
        os.makedirs(_KEY_CACHE_DIR, exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(keys_to_numpy(keys), f)
    return keys


def keys_to_numpy(keys: FunctionKeys) -> dict:
    """The key blob: numpy arrays, ints and tuples only, in the layout the
    JAX package writes for its key cache."""
    idx = keys.index

    def arr(t):
        a = limbs.to_numpy(t)
        return a.astype(np.uint32) if a.dtype == np.int32 else a

    def tab(t):
        return {
            "vals": arr(t.vals), "gather_idx": arr(t.gather_idx).astype(np.int32),
            "flags": arr(t.flags), "ends": arr(t.ends),
            "out_idx": arr(t.out_idx).astype(np.int32), "out_size": t.out_size,
        }

    return {
        "program_id": keys.program_id, "function": keys.function,
        "counts": keys.constraint_counts,
        "n": idx.n, "m": idx.m, "ell": idx.ell, "num_inputs": idx.num_inputs,
        "var_pos": np.asarray(idx.var_pos),
        "srs_max_degree": idx.srs.max_degree,
        "matrices": [
            {
                "name": mi.name,
                **{
                    f"{p}_{kind}": arr(getattr(mi, f"{p}_{kind}"))
                    for kind in ("poly", "evals")
                    for p in ("row", "col", "cval", "rcp")
                },
                "commitments": mi.commitments,
                "by_row": tab(mi.by_row), "by_col": tab(mi.by_col),
            }
            for mi in idx.matrices
        ],
    }


def keys_from_numpy(blob: dict, srs_blob, device=None) -> FunctionKeys:
    """Key blob (`keys_to_numpy`, or the JAX package's key cache) + SRS blob
    (`Srs.to_numpy`, or the JAX package's `Srs.save` layout; an `Srs` is
    taken as it is) -> `FunctionKeys` on `device`."""
    device = limbs.resolve_device(device)
    srs = srs_blob if isinstance(srs_blob, Srs) else srs_from_numpy(srs_blob, device)

    def tab(d):
        def t(k, dtype):
            return torch.from_numpy(np.asarray(d[k]).astype(dtype)).to(device)

        return SparseTables(
            vals=limbs.to_tensor(np.asarray(d["vals"]), device),
            gather_idx=t("gather_idx", np.int64),
            flags=t("flags", bool), ends=t("ends", bool),
            out_idx=t("out_idx", np.int64), out_size=d["out_size"],
        )

    matrices = [
        MatrixIndex(
            md["name"],
            *[limbs.to_tensor(np.asarray(md[f"{p}_poly"]), device)
              for p in ("row", "col", "cval", "rcp")],
            *[limbs.to_tensor(np.asarray(md[f"{p}_evals"]), device)
              for p in ("row", "col", "cval", "rcp")],
            md["commitments"], tab(md["by_row"]), tab(md["by_col"]),
        )
        for md in blob["matrices"]
    ]
    index = Index(
        srs, blob["n"], blob["m"], blob["ell"], blob["num_inputs"],
        np.asarray(blob["var_pos"]), matrices,
    )
    return FunctionKeys(
        blob["program_id"], blob["function"], index,
        VerifyingKey.from_index(index), blob["counts"],
    )


def _load_keys(path: str, device) -> FunctionKeys:
    with open(path, "rb") as f:
        blob = pickle.load(f)
    srs = Srs.load_or_generate(blob["srs_max_degree"], device=device)
    return keys_from_numpy(blob, srs, device)


def deploy_keys(registry: Registry, program_id: str, srs=None,
                device=None) -> Dict[str, FunctionKeys]:
    """Key synthesis for every function of a program (the `vm.deploy` hot
    loop)."""
    prog = registry.get(program_id)
    return {
        fname: synthesize_keys(registry, program_id, fname, srs=srs, device=device)
        for fname in prog.functions
    }


def synthesize_and_check(keys: FunctionKeys, registry: Registry, inputs,
                         caller: int = 0, rng_nonce=None) -> Synthesis:
    syn = synthesize_execution(
        registry, keys.program_id, keys.function, inputs,
        caller=caller, rng_nonce=rng_nonce,
    )
    cs = syn.cs
    idx = keys.index
    ell = 1 << max(0, (cs.num_inputs - 1).bit_length())
    if ell != keys.vk.ell:
        raise ValueError(
            f"circuit shape drift: {cs.num_inputs} public inputs vs key ell={keys.vk.ell}"
        )
    n = 1 << max(
        0,
        (max(cs.num_constraints, cs.num_variables + (ell - cs.num_inputs), 2) - 1)
        .bit_length(),
    )
    if n != idx.n:
        raise ValueError(f"circuit shape drift: |H|={n} vs key n={idx.n}")
    return syn


def prove_execution(
    keys: FunctionKeys,
    registry: Registry,
    inputs: List,
    caller: int = 0,
    rng_nonce=None,
    rng=None,
) -> ExecutionProof:
    """Synthesize the concrete circuit and prove it under the function keys
    (the `Trace::prove_execution` stage), on the device the keys lie on.
    `rng` seeds the prover's hiding masks (default: the system's entropy)."""
    with prof.stage("pipeline/synthesize"):
        syn = synthesize_and_check(keys, registry, inputs, caller, rng_nonce)
    with prof.stage("pipeline/prove"):
        proof = prove(keys.index, syn.cs, rng=rng)
    return ExecutionProof(
        keys.program_id, keys.function, syn.public_inputs, proof, syn.transition
    )


def verify_execution(keys_or_vk, ep: ExecutionProof, debug: bool = False) -> bool:
    """Verify a proven transition (`Trace::verify_execution_proof` twin).

    debug=True names the failed verifier check on stdout (snark/verifier.py)."""
    vk = keys_or_vk.vk if isinstance(keys_or_vk, FunctionKeys) else keys_or_vk
    return verify(vk, ep.public_inputs, ep.proof, debug=debug)
