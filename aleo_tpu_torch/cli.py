"""`aleo` CLI — account / package / execution commands.

Counterpart of the JAX package's `cli.py`, the twin of the reference CLI
(`upstream:cli/commands/mod.rs:62-99`):

  account new|import|encrypt|decrypt   (account.rs)
  new <name>                           (new.rs: Package::create scaffold)
  build                                (build.rs: circuit key synthesis)
  clean                                (clean.rs)
  run <function> [inputs...]           (run.rs: local run, no proof, metrics)
  deploy                               (deploy.rs)
  execute <function> [inputs...]       (execute.rs)
  transfer                             (transfer.rs, 4 TransferTypeArg kinds)

Network commands run against either a persistent local dev ledger
(~/.aleo_tpu_torch/devnet.pkl, $ALEO_TORCH_DEVNET_PATH — the snarkOS devnet
role) or a REST endpoint via --endpoint http://... .

The commands that make tensors (build --offline-synthesis, deploy, execute,
transfer, develop) take --device; without it they run on CUDA and raise where
there is none. The devnet file holds the verifying keys' SRS in host form
(`Srs.to_numpy`), so it is bound to no device: it is loaded back onto the
command's device, and onto the CPU by `devnet`, which runs no kernel.

Usage: python -m aleo_tpu_torch.cli <command> ...
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import pickle
import shutil

from .pcs.srs import srs_from_numpy
from .program.parser import parse_program
from .sdk import account as acct
from .sdk import encryptor
from .sdk.api_client import HttpAPIClient, LocalAPIClient
from .sdk.dev_server import _parse_inputs
from .sdk.ledger import Ledger
from .sdk.program_manager import ProgramManager, TransferType

from .config import DEVNET_PATH, ENDPOINT, NETWORK, SERVER_HOST, SERVER_PORT

MANIFEST = "program.json"


# -- local devnet persistence -------------------------------------------------


def _load_ledger(device) -> Ledger:
    """The devnet file's ledger, its verifying keys' SRS on `device` (one
    `Srs` for the keys that shared one when saved)."""
    if not os.path.exists(DEVNET_PATH):
        return Ledger()
    with open(DEVNET_PATH, "rb") as f:
        ledger = pickle.load(f)
    on_device = {}
    for key, vk in ledger.function_vks.items():
        blob = vk.srs
        if id(blob) not in on_device:
            on_device[id(blob)] = srs_from_numpy(blob, device=device)
        ledger.function_vks[key] = dataclasses.replace(vk, srs=on_device[id(blob)])
    return ledger


def _save_ledger(ledger: Ledger):
    """Pickle a copy of the ledger whose verifying keys hold their SRS as
    `Srs.to_numpy` blobs (numpy arrays and ints, no tensor); the ledger
    itself is left as it is."""
    host, blobs = copy.copy(ledger), {}
    host.function_vks = {}
    for key, vk in ledger.function_vks.items():
        if id(vk.srs) not in blobs:
            blobs[id(vk.srs)] = vk.srs.to_numpy()
        host.function_vks[key] = dataclasses.replace(vk, srs=blobs[id(vk.srs)])
    os.makedirs(os.path.dirname(DEVNET_PATH), exist_ok=True)
    with open(DEVNET_PATH, "wb") as f:
        pickle.dump(host, f)


def _client(args):
    if getattr(args, "endpoint", None):
        return HttpAPIClient(args.endpoint, device=args.device), None
    ledger = _load_ledger(args.device)
    return LocalAPIClient(ledger, device=args.device), ledger


def _manager(args):
    client, ledger = _client(args)
    if args.private_key:
        pm = ProgramManager(
            client, private_key=acct.PrivateKey.from_string(args.private_key),
            device=args.device,
        )
        password = None
    elif args.ciphertext and args.password:
        pm = ProgramManager(
            client,
            private_key_ciphertext=encryptor.PrivateKeyCiphertext.from_string(
                args.ciphertext
            ),
            device=args.device,
        )
        password = args.password
    else:
        raise SystemExit(
            "provide --private-key, or --ciphertext with --password"
        )
    return pm, password, ledger


# -- package helpers (Package::open twin) -------------------------------------


def _read_package(path="."):
    manifest_path = os.path.join(path, MANIFEST)
    if not os.path.exists(manifest_path):
        raise SystemExit(f"no {MANIFEST} in {os.path.abspath(path)} — not an Aleo package")
    with open(manifest_path) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "main.aleo")) as f:
        source = f.read()
    prog = parse_program(source)
    if prog.id != manifest["program"]:
        raise SystemExit(
            f"manifest program {manifest['program']} != main.aleo id {prog.id}"
        )
    imports = {}
    imports_dir = os.path.join(path, "imports")
    if os.path.isdir(imports_dir):
        for fn in sorted(os.listdir(imports_dir)):
            if fn.endswith(".aleo"):
                with open(os.path.join(imports_dir, fn)) as f:
                    imports[fn[:-5] + ".aleo"] = f.read()
    return manifest, source, prog, imports


# -- commands -----------------------------------------------------------------


def cmd_account(args):
    if args.action == "new":
        pk = acct.PrivateKey(seed=args.seed)
    elif args.action == "import":
        pk = acct.PrivateKey.from_string(args.key)
    elif args.action == "encrypt":
        pk = acct.PrivateKey.from_string(args.key)
        ct = encryptor.encrypt_private_key_with_secret(pk, args.password)
        print(ct.to_string())
        return
    elif args.action == "decrypt":
        ct = encryptor.PrivateKeyCiphertext.from_string(args.ciphertext)
        pk = encryptor.decrypt_private_key_with_secret(ct, args.password)
    model = {
        "private_key": pk.to_string(),
        "view_key": pk.view_key().to_string(),
        "address": pk.address().to_string(),
    }
    for k, v in model.items():
        print(f"  {k:12s} {v}")
    if getattr(args, "write", False):
        # AccountModel JSON to disk (cli/helpers/serialize.rs:28-38)
        with open(args.write, "w") as f:
            json.dump(model, f, indent=2)
        print(f"wrote {args.write}")
    if getattr(args, "encrypt_with", None):
        ct = encryptor.encrypt_private_key_with_secret(pk, args.encrypt_with)
        print(f"  {'ciphertext':12s} {ct.to_string()}")


def cmd_new(args):
    name = args.name
    pid = f"{name}.aleo"
    os.makedirs(name, exist_ok=False)
    with open(os.path.join(name, MANIFEST), "w") as f:
        json.dump(
            {"program": pid, "version": "0.0.0", "description": "", "license": "MIT"},
            f, indent=2,
        )
    with open(os.path.join(name, "main.aleo"), "w") as f:
        f.write(
            f"program {pid};\n\nfunction hello:\n"
            "    input r0 as u32.public;\n    input r1 as u32.private;\n"
            "    add r0 r1 into r2;\n    output r2 as u32.private;\n"
        )
    print(f"created package {name}/")


def cmd_build(args):
    """Circuit key synthesis per function (build.rs:36-57)."""
    from .program.interpreter import Registry
    from .snark import pipeline

    _m, source, prog, imports = _read_package(args.path)
    reg = Registry()
    for src in imports.values():
        reg.add(parse_program(src))
    reg.add(prog)
    build_dir = os.path.join(args.path, "build")
    os.makedirs(build_dir, exist_ok=True)
    for fname in prog.functions:
        if args.offline_synthesis:
            keys = pipeline.synthesize_keys(reg, prog.id, fname, device=args.device)
            counts = keys.constraint_counts
        else:
            from .program.synthesizer import synthesize_execution

            syn = synthesize_execution(
                reg, prog.id, fname, pipeline.burner_inputs(prog, fname),
                caller=1, rng_nonce=lambda: 1,
            )
            counts = syn.constraint_counts
        print(f"  {prog.id}/{fname}: {counts['total']} constraints")
    with open(os.path.join(build_dir, "main.aleo"), "w") as f:
        f.write(source)
    print(f"built {prog.id}")


def cmd_clean(args):
    build_dir = os.path.join(args.path, "build")
    if os.path.isdir(build_dir):
        shutil.rmtree(build_dir)
        print("cleaned build/")
    else:
        print("nothing to clean")


def cmd_run(args):
    """Local execution, no network, no proof + metrics (run.rs:34-95)."""
    from .program.interpreter import Interpreter, Registry
    from .program.synthesizer import synthesize_execution

    _m, _source, prog, imports = _read_package(args.path)
    reg = Registry()
    for src in imports.values():
        reg.add(parse_program(src))
    reg.add(prog)
    inputs = _parse_inputs(args.inputs)
    syn = synthesize_execution(reg, prog.id, args.function, inputs, caller=1)
    print(f"🚀 Executed '{prog.id}/{args.function}' locally")
    for i, out in enumerate(syn.transition.outputs):
        print(f"  output r{i}: {out.data} ({out.type_})")
    print("  metrics:")
    for stage, count in syn.constraint_counts.items():
        print(f"    {stage:8s} {count} constraints")


def cmd_deploy(args):
    pm, password, ledger = _manager(args)
    _m, source, prog, imports = _read_package(args.path)
    for pid, src in imports.items():
        pm.add_program(src)
    if args.estimate_fee:
        print(f"estimated fee: {pm.estimate_deployment_fee(source)} microcredits")
        return
    tx_id = pm.deploy_program(
        source, fee=args.fee, password=password, prove=args.prove
    )
    if ledger is not None:
        _save_ledger(ledger)
    print(f"deployment transaction: {tx_id}")


def cmd_execute(args):
    pm, password, ledger = _manager(args)
    inputs = _parse_inputs(args.inputs)
    program_id = args.program
    if args.estimate_fee:
        print(
            f"estimated fee: "
            f"{pm.estimate_execution_fee(program_id, args.function, inputs)}"
            " microcredits"
        )
        return
    tx_id = pm.execute_program(
        program_id, args.function, inputs, fee=args.fee,
        password=password, prove=args.prove,
    )
    if ledger is not None:
        _save_ledger(ledger)
    print(f"execution transaction: {tx_id}")


def cmd_transfer(args):
    pm, password, ledger = _manager(args)
    ttype = {
        "private": TransferType.Private,
        "public": TransferType.Public,
        "private_to_public": TransferType.PrivateToPublic,
        "public_to_private": TransferType.PublicToPrivate,
    }[args.transfer_type]
    tx_id = pm.transfer(
        args.amount, args.fee, args.recipient, ttype,
        password=password, prove=args.prove,
    )
    if ledger is not None:
        _save_ledger(ledger)
    print(f"transfer transaction: {tx_id}")


def cmd_devnet(args):
    """Local-devnet helpers (the snarkOS --dev bootstrap role)."""
    ledger = _load_ledger("cpu")        # runs no kernel: the keys' SRS stays on the host
    if args.action == "reset":
        if os.path.exists(DEVNET_PATH):
            os.remove(DEVNET_PATH)
        print("devnet reset")
        return
    if args.action == "mint":
        ledger.genesis_mint(args.address, args.amount, n_records=args.records)
        _save_ledger(ledger)
        print(f"minted {args.amount} microcredits to {args.address}")
        return
    if args.action == "status":
        print(f"height: {ledger.latest_height}")
        print(f"hash:   {ledger.latest_hash}")
        print(f"programs: {sorted(ledger.program_sources)}")


def cmd_develop(args):
    """Start the development server (rust/develop/src/cli.rs:41-67)."""
    from .sdk.dev_server import DevServer

    ct = (
        encryptor.PrivateKeyCiphertext.from_string(args.key_ciphertext)
        if args.key_ciphertext
        else None
    )
    ledger = _load_ledger(args.device)
    server = DevServer(
        LocalAPIClient(ledger, device=args.device), key_ciphertext=ct,
        host=args.host, port=args.port, prove=args.prove, device=args.device,
    )
    print(f"serving on {args.host}:{args.port}")
    server.start(background=False)


def _add_key_args(p):
    p.add_argument("--private-key", help="plaintext private key")
    p.add_argument("--ciphertext", help="encrypted private key ciphertext")
    p.add_argument("--password", help="password for the ciphertext")
    p.add_argument("--endpoint", default=ENDPOINT or None,
                   help="REST endpoint (default: local devnet / $ALEO_TORCH_ENDPOINT)")
    p.add_argument("--fee", type=int, default=0)
    p.add_argument("--prove", action="store_true", help="generate real SNARK proofs")
    _add_device_arg(p)


def _add_device_arg(p):
    p.add_argument("--device", help="torch device of the keys and proofs "
                   "(default: CUDA, an error where there is none)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="aleo", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("account")
    pa = p.add_subparsers(dest="action", required=True)
    pn = pa.add_parser("new")
    pn.add_argument("--seed", type=int)
    pn.add_argument("--write", help="write AccountModel JSON to this path")
    pn.add_argument("--encrypt", dest="encrypt_with", help="also print ciphertext")
    pi = pa.add_parser("import")
    pi.add_argument("key")
    pi.add_argument("--write")
    pe = pa.add_parser("encrypt")
    pe.add_argument("--key", required=True)
    pe.add_argument("--password", required=True)
    pd = pa.add_parser("decrypt")
    pd.add_argument("--ciphertext", required=True)
    pd.add_argument("--password", required=True)
    p.set_defaults(fn=cmd_account)

    p = sub.add_parser("new")
    p.add_argument("name")
    p.set_defaults(fn=cmd_new)

    p = sub.add_parser("build")
    p.add_argument("--path", default=".")
    p.add_argument("--offline-synthesis", action="store_true",
                   help="full proving-key synthesis (slow)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("clean")
    p.add_argument("--path", default=".")
    p.set_defaults(fn=cmd_clean)

    p = sub.add_parser("run")
    p.add_argument("function")
    p.add_argument("inputs", nargs="*")
    p.add_argument("--path", default=".")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("deploy")
    p.add_argument("--path", default=".")
    p.add_argument("--estimate-fee", action="store_true")
    _add_key_args(p)
    p.set_defaults(fn=cmd_deploy)

    p = sub.add_parser("execute")
    p.add_argument("program")
    p.add_argument("function")
    p.add_argument("inputs", nargs="*")
    p.add_argument("--estimate-fee", action="store_true")
    _add_key_args(p)
    p.set_defaults(fn=cmd_execute)

    p = sub.add_parser("transfer")
    p.add_argument("--amount", type=int, required=True)
    p.add_argument("--recipient", required=True)
    p.add_argument("--transfer-type", default="private",
                   choices=["private", "public", "private_to_public",
                            "public_to_private"])
    _add_key_args(p)
    p.set_defaults(fn=cmd_transfer)

    p = sub.add_parser("devnet")
    pa = p.add_subparsers(dest="action", required=True)
    pr = pa.add_parser("reset")
    pm_ = pa.add_parser("mint")
    pm_.add_argument("--address", required=True)
    pm_.add_argument("--amount", type=int, required=True)
    pm_.add_argument("--records", type=int, default=4)
    ps = pa.add_parser("status")
    p.set_defaults(fn=cmd_devnet)

    p = sub.add_parser("develop")
    p.add_argument("--host", default=SERVER_HOST)
    p.add_argument("--port", type=int, default=SERVER_PORT)
    p.add_argument("--key-ciphertext")
    p.add_argument("--prove", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_develop)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
