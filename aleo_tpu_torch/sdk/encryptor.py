"""Password-based private-key encryption (the account Encryptor).

Capability twin of `upstream:rust/src/account/encryptor.rs:24-82`:
the private-key seed is blinded with a Poseidon-derived factor
(`blinding = hash_psd2(domain, nonce, secret)`, `key = blinding * seed`),
then the `{key, nonce}` struct is symmetrically encrypted under the secret
(Poseidon key stream, the `Plaintext::encrypt_symmetric` role). Poseidon
constants/domains are this framework's own (snarkVM's are not vendored in
the reference; see aleo_tpu_torch/reference/poseidon.py).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from .. import params
from ..reference import poseidon
from .account import PrivateKey

R = params.R


def _domain_sep(s: str) -> int:
    """Field domain separator from a string (LE bytes, mod r) — the
    `Field::new_domain_separator` role."""
    return int.from_bytes(s.encode(), "little") % R


class DecryptionError(Exception):
    """Wrong secret (the reference's decrypt_symmetric error surface)."""


@dataclass(frozen=True)
class PrivateKeyCiphertext:
    """Encrypted {key, nonce} pair + authentication tag (the wasm
    `PrivateKeyCiphertext`,
    `upstream:wasm/src/account/private_key_ciphertext.rs:38-72`;
    the tag plays the role of snarkVM's authenticated symmetric decryption,
    which errors on a wrong secret — encryptor.rs tests at :101-108)."""

    c_key: int
    c_nonce: int
    tag: int

    def to_string(self) -> str:
        return f"ciphertext1{self.c_key:064x}{self.c_nonce:064x}{self.tag:064x}"

    @staticmethod
    def from_string(s: str) -> "PrivateKeyCiphertext":
        assert s.startswith("ciphertext1"), "bad ciphertext prefix"
        body = s[len("ciphertext1"):]
        assert len(body) == 192
        return PrivateKeyCiphertext(
            int(body[:64], 16), int(body[64:128], 16), int(body[128:], 16)
        )


def _stream_keys(secret_field: int, n: int):
    sponge = poseidon.PoseidonSponge(2, domain="aleo-tpu/encrypt-symmetric")
    sponge.absorb([secret_field])
    return sponge.squeeze(n)


def encrypt_private_key_with_secret(
    private_key: PrivateKey, secret: str, nonce: int | None = None
) -> PrivateKeyCiphertext:
    domain = _domain_sep("private_key")
    secret_f = _domain_sep(secret)
    if nonce is None:
        nonce = secrets.randbelow(R)
    blinding = poseidon.hash_psd(2, [domain, nonce, secret_f], domain="aleo-tpu/psd2")
    key = blinding * private_key.seed % R
    k1, k2 = _stream_keys(secret_f, 2)
    c_key, c_nonce = (key + k1) % R, (nonce + k2) % R
    tag = poseidon.hash_psd(2, [c_key, c_nonce, secret_f], domain="aleo-tpu/encrypt-mac")
    return PrivateKeyCiphertext(c_key, c_nonce, tag)


def decrypt_private_key_with_secret(
    ciphertext: PrivateKeyCiphertext, secret: str
) -> PrivateKey:
    domain = _domain_sep("private_key")
    secret_f = _domain_sep(secret)
    tag = poseidon.hash_psd(
        2, [ciphertext.c_key, ciphertext.c_nonce, secret_f], domain="aleo-tpu/encrypt-mac"
    )
    if tag != ciphertext.tag:
        raise DecryptionError("wrong secret")
    k1, k2 = _stream_keys(secret_f, 2)
    key = (ciphertext.c_key - k1) % R
    nonce = (ciphertext.c_nonce - k2) % R
    blinding = poseidon.hash_psd(2, [domain, nonce, secret_f], domain="aleo-tpu/psd2")
    seed = key * pow(blinding, -1, R) % R
    return PrivateKey(seed)
