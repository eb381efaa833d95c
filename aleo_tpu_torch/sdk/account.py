"""Account keys, addresses, and signatures (Edwards-BLS12 over Fr).

Capability twin of the reference's account layer:
  * `PrivateKey` / `ViewKey` / `Address` (wasm classes at
    `upstream:wasm/src/account/private_key.rs:38-127`, `view_key.rs`,
    `address.rs`): seeded key generation, address derivation, bech32
    serialization with the same HRPs (APrivateKey1/AViewKey1/aleo1).
  * Schnorr signatures over the Edwards subgroup (`signature.rs:37-63`).
  * Record ownership/decryption via the view key (ECDH + Poseidon stream),
    mirroring `record_ciphertext.rs:35-65`.

Key derivation follows the Aleo construction shape (sk_sig/r_sig scalars ->
pk_sig + pr_sig + sk_prf*G address) with Poseidon PRFs from our parameter
set (snarkVM's exact constants are not vendored in the reference; see
aleo_tpu_torch/reference/poseidon.py).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from .. import params
from ..reference import edwards, poseidon

R = params.R
ELL = params.EDWARDS_ORDER

_BECH32_CHARSET = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"


def _bech32_polymod(values):
    gen = [0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3]
    chk = 1
    for v in values:
        b = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            chk ^= gen[i] if ((b >> i) & 1) else 0
    return chk


def _bech32_hrp_expand(hrp):
    return [ord(x) >> 5 for x in hrp] + [0] + [ord(x) & 31 for x in hrp]


def _bech32_create_checksum(hrp, data):
    values = _bech32_hrp_expand(hrp) + data
    polymod = _bech32_polymod(values + [0, 0, 0, 0, 0, 0]) ^ 1
    return [(polymod >> 5 * (5 - i)) & 31 for i in range(6)]


def _convertbits(data, frombits, tobits, pad=True):
    acc, bits, ret = 0, 0, []
    maxv = (1 << tobits) - 1
    for value in data:
        acc = (acc << frombits) | value
        bits += frombits
        while bits >= tobits:
            bits -= tobits
            ret.append((acc >> bits) & maxv)
    if pad and bits:
        ret.append((acc << (tobits - bits)) & maxv)
    return ret


def bech32_encode(hrp: str, payload: bytes) -> str:
    data = _convertbits(list(payload), 8, 5)
    checksum = _bech32_create_checksum(hrp, data)
    return hrp + "1" + "".join(_BECH32_CHARSET[d] for d in data + checksum)


def bech32_decode(s: str) -> tuple:
    pos = s.rfind("1")
    hrp, data_part = s[:pos], s[pos + 1 :]
    data = [_BECH32_CHARSET.find(c) for c in data_part]
    if _bech32_polymod(_bech32_hrp_expand(hrp) + data) != 1:
        raise ValueError("bad bech32 checksum")
    payload = _convertbits(data[:-6], 5, 8, pad=False)
    return hrp, bytes(payload)


def _prf(domain: str, *inputs: int) -> int:
    return poseidon.hash_psd(2, list(inputs), domain=f"aleo-tpu/{domain}")


def _prf_scalar(domain: str, *inputs: int) -> int:
    return _prf(domain, *inputs) % ELL


def address_to_field(addr: str) -> int:
    """aleo1... -> x-coordinate as an Fr element."""
    hrp, payload = bech32_decode(addr)
    assert hrp == "aleo"
    return int.from_bytes(payload, "little") % R


def field_to_address(x: int) -> str:
    return bech32_encode("aleo", int(x).to_bytes(32, "little"))


@dataclass
class Address:
    point: tuple  # Edwards affine (x, y)

    @property
    def x(self) -> int:
        return self.point[0]

    def to_string(self) -> str:
        return field_to_address(self.point[0])

    @staticmethod
    def from_string(s: str) -> "Address":
        x = address_to_field(s)
        # Recover y from the curve equation. Both roots lie on the curve;
        # pick the one in the prime-order subgroup (the snarkVM x-coordinate
        # recovery convention that makes `is_owner_with_address_x_coordinate`
        # sound, upstream:rust/src/api/blocking.rs:275).
        a, d = params.EDWARDS_A, params.EDWARDS_D
        num = (1 - a * x * x) % R
        den = (1 - d * x * x) % R
        from ..reference.field import FR

        y = FR.sqrt(num * pow(den, -1, R) % R)
        P = (x, y)
        if edwards.mul(ELL, P) != (0, 1):
            P = (x, (R - y) % R)
            assert edwards.mul(ELL, P) == (0, 1), "x not on the prime subgroup"
        return Address(P)

    def __str__(self):
        return self.to_string()


class PrivateKey:
    def __init__(self, seed: int | None = None):
        self.seed = seed if seed is not None else secrets.randbits(250)
        self.sk_sig = _prf_scalar("sk_sig", self.seed)
        self.r_sig = _prf_scalar("r_sig", self.seed)
        G = edwards.generator()
        self.pk_sig = edwards.mul(self.sk_sig, G)
        self.pr_sig = edwards.mul(self.r_sig, G)
        self.sk_prf = _prf_scalar("sk_prf", self.pk_sig[0], self.pr_sig[0])
        self.sk = (self.sk_sig + self.r_sig + self.sk_prf) % ELL

    @staticmethod
    def from_seed(seed: int) -> "PrivateKey":
        return PrivateKey(seed)

    @staticmethod
    def from_string(s: str) -> "PrivateKey":
        hrp, payload = bech32_decode(s)
        assert hrp == "aprivatekey1" or hrp == "APrivateKey1".lower()
        return PrivateKey(int.from_bytes(payload, "little"))

    def to_string(self) -> str:
        return bech32_encode("aprivatekey1", self.seed.to_bytes(32, "little"))

    def view_key(self) -> "ViewKey":
        return ViewKey(self.sk)

    def address(self) -> Address:
        return Address(edwards.mul(self.sk, edwards.generator()))

    # -- Schnorr signature ----------------------------------------------------

    def sign(self, message: list) -> tuple:
        """message: list of Fr ints. Returns (challenge, response)."""
        k = _prf_scalar("sig-nonce", self.seed, *message)
        gk = edwards.mul(k, edwards.generator())
        addr = self.address()
        c = _prf_scalar("sig-challenge", gk[0], addr.x, *message)
        s = (k - c * self.sk) % ELL
        return (c, s)

    def __str__(self):
        return self.to_string()


@dataclass
class ViewKey:
    scalar: int

    def to_string(self) -> str:
        return bech32_encode("aviewkey1", self.scalar.to_bytes(32, "little"))

    @staticmethod
    def from_string(s: str) -> "ViewKey":
        hrp, payload = bech32_decode(s)
        assert hrp == "aviewkey1"
        return ViewKey(int.from_bytes(payload, "little"))

    def address(self) -> Address:
        return Address(edwards.mul(self.scalar, edwards.generator()))

    def __str__(self):
        return self.to_string()


def verify(addr: Address, message: list, signature: tuple) -> bool:
    c, s = signature
    G = edwards.generator()
    # gk' = s G + c A ; check c == H(gk'.x, addr.x, msg)
    gk = edwards.add(edwards.mul(s, G), edwards.mul(c, addr.point))
    return c == _prf_scalar("sig-challenge", gk[0], addr.x, *message)


# ---------------------------------------------------------------------------
# Record encryption (ECDH + Poseidon stream), as in the reference's
# RecordCiphertext/decrypt + is_owner flow.
# ---------------------------------------------------------------------------


def encrypt_fields(addr: Address, plaintext: list, esk: int | None = None):
    """Returns (ephemeral_pub_x, ciphertext fields)."""
    esk = esk or (secrets.randbits(249) % ELL)
    G = edwards.generator()
    eph = edwards.mul(esk, G)
    shared = edwards.mul(esk, addr.point)
    keys = []
    sponge = poseidon.PoseidonSponge(2, domain="aleo-tpu/record-encrypt")
    sponge.absorb([shared[0], shared[1]])
    keys = sponge.squeeze(len(plaintext))
    ct = [(p + k) % R for p, k in zip(plaintext, keys)]
    return (eph, ct)


def decrypt_fields(view: ViewKey, eph: tuple, ciphertext: list, shared=None):
    """shared: optional precomputed ECDH point (the device batch-scan path,
    curves/edwards_device.shared_secrets)."""
    if shared is None:
        shared = edwards.mul(view.scalar, eph)
    sponge = poseidon.PoseidonSponge(2, domain="aleo-tpu/record-encrypt")
    sponge.absorb([shared[0], shared[1]])
    keys = sponge.squeeze(len(ciphertext))
    return [(c - k) % R for c, k in zip(ciphertext, keys)]
