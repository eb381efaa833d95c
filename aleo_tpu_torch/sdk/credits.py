"""The built-in `credits.aleo` program (value-transfer + fees).

Capability twin of the testnet3 `credits.aleo` the reference's transfer and
fee flows target (`upstream:rust/src/program/transfer.rs:23-110`:
TransferType::{Private, PrivateToPublic, Public, PublicToPrivate};
`Credits` trait reading `microcredits` at `rust/src/lib.rs:256-275`),
expressed in this framework's Aleo-instruction subset.
"""

from ..program.interpreter import Registry
from ..program.parser import parse_program

CREDITS_PROGRAM = """
program credits.aleo;

record credits:
    owner as address.private;
    gates as u64.private;
    microcredits as u64.private;

mapping account:
    key owner as address.public;
    value microcredits as u64.public;

// Devnet genesis helper (the snarkOS --dev beacon mint role).
function mint:
    input r0 as address.private;
    input r1 as u64.private;
    cast r0 0u64 r1 into r2 as credits.record;
    output r2 as credits.record;

function transfer_private:
    input r0 as credits.record;
    input r1 as address.private;
    input r2 as u64.private;
    sub r0.microcredits r2 into r3;
    cast r1 0u64 r2 into r4 as credits.record;
    cast r0.owner 0u64 r3 into r5 as credits.record;
    output r4 as credits.record;
    output r5 as credits.record;

function transfer_public:
    input r0 as address.public;
    input r1 as u64.public;
    finalize self.caller r0 r1;

finalize transfer_public:
    input r0 as address.public;
    input r1 as address.public;
    input r2 as u64.public;
    get.or_init account[r0] 0u64 into r3;
    sub r3 r2 into r4;
    set r4 into account[r0];
    get.or_init account[r1] 0u64 into r5;
    add r5 r2 into r6;
    set r6 into account[r1];

function transfer_private_to_public:
    input r0 as credits.record;
    input r1 as address.public;
    input r2 as u64.public;
    sub r0.microcredits r2 into r3;
    cast r0.owner 0u64 r3 into r4 as credits.record;
    output r4 as credits.record;
    finalize r1 r2;

finalize transfer_private_to_public:
    input r0 as address.public;
    input r1 as u64.public;
    get.or_init account[r0] 0u64 into r2;
    add r2 r1 into r3;
    set r3 into account[r0];

function transfer_public_to_private:
    input r0 as address.public;
    input r1 as u64.public;
    cast r0 0u64 r1 into r2 as credits.record;
    output r2 as credits.record;
    finalize self.caller r1;

finalize transfer_public_to_private:
    input r0 as address.public;
    input r1 as u64.public;
    get.or_init account[r0] 0u64 into r2;
    sub r2 r1 into r3;
    set r3 into account[r0];

// Fee payment: burns r1 microcredits from the record, returns change.
function fee:
    input r0 as credits.record;
    input r1 as u64.public;
    sub r0.microcredits r1 into r2;
    cast r0.owner 0u64 r2 into r3 as credits.record;
    output r3 as credits.record;

function join:
    input r0 as credits.record;
    input r1 as credits.record;
    add r0.microcredits r1.microcredits into r2;
    cast r0.owner 0u64 r2 into r3 as credits.record;
    output r3 as credits.record;

function split:
    input r0 as credits.record;
    input r1 as u64.private;
    sub r0.microcredits r1 into r2;
    cast r0.owner 0u64 r1 into r3 as credits.record;
    cast r0.owner 0u64 r2 into r4 as credits.record;
    output r3 as credits.record;
    output r4 as credits.record;
"""


def credits_program():
    return parse_program(CREDITS_PROGRAM)


def registry_with_credits() -> Registry:
    reg = Registry()
    reg.add(credits_program())
    return reg
