"""BLS12-377 / Edwards-BLS12 curve and field parameters.

This module is the single source of truth for all numeric constants of the
proving system. It mirrors the parameter set used by the reference stack
(snarkVM 0.14.5 under the upstream repository — see `SURVEY.md` §0; the reference
delegates all cryptography to the `snarkvm-curves`/`snarkvm-fields` crates
pinned in `Cargo.lock:2637-2668`), namely:

  * BLS12-377: a pairing-friendly Barreto-Lynn-Scott curve with embedding
    degree 12 over a 377-bit prime field Fq, scalar field Fr (253 bits,
    2-adicity 47 — which is what makes large radix-2 NTTs possible).
  * Edwards-BLS12: a twisted Edwards curve defined over Fr(BLS12-377), used
    for account keys / signatures (reference: `rust/src/account/encryptor.rs`,
    `wasm/src/account/*`).

Every constant below is validated by `validate()` (exercised in
tests/test_params.py): internal consistency (q, r derived from the BLS
parameter x), subgroup orders, curve membership of generators, and the
2-adic roots of unity. Nothing is taken on faith.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# BLS12-377 definition
# ---------------------------------------------------------------------------

# BLS parameter ("x" in the BLS12 construction).
BLS_X = 0x8508C00000000001  # 9586122913090633729, x ≡ 1 (mod 3·2^46)

# Base field modulus  q = ((x - 1)^2 / 3) * r + x   (377 bits)
Q = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001

# Scalar field modulus  r = x^4 - x^2 + 1   (253 bits)
R = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001

# 2-adicity: q - 1 = 2^46 * odd,  r - 1 = 2^47 * odd
FQ_TWO_ADICITY = 46
FR_TWO_ADICITY = 47

# Smallest multiplicative generator of Fr (standard for this curve).
FR_GENERATOR = 22

# 2^47-th primitive root of unity in Fr: FR_GENERATOR^((r-1)/2^47) mod r.
FR_TWO_ADIC_ROOT = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)

# G1: y^2 = x^3 + 1 over Fq  (a = 0, b = 1)
G1_B = 1
# #E(Fq) = q + 1 - t with trace t = x + 1  =>  #E(Fq) = q - x = h1 * r
G1_COFACTOR = (Q - BLS_X) // R  # = (x - 1)^2 / 3

# G1 generator (standard generator of the r-torsion subgroup).
G1_GEN_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
G1_GEN_Y = 241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030

# Fq2 = Fq[u] / (u^2 - FQ2_NONRESIDUE)
FQ2_NONRESIDUE = Q - 5  # -5

# G2 lives on the D-type sextic twist  E'/Fq2 : y^2 = x^3 + b'  with b' = 1/u.
# 1/u = -u/5, i.e. b' = (0, -1/5 mod q) in (c0, c1) coordinates.
G2_B_C0 = 0
G2_B_C1 = Q - pow(5, Q - 2, Q)  # -(5^-1) mod q

# G2 generator (r-torsion subgroup of the twist).
G2_GEN_X_C0 = 233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294
G2_GEN_X_C1 = 140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118
G2_GEN_Y_C0 = 63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423
G2_GEN_Y_C1 = 149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491

# ---------------------------------------------------------------------------
# Edwards-BLS12 (account curve; base field = Fr of BLS12-377)
# ---------------------------------------------------------------------------

# Twisted Edwards: a*x^2 + y^2 = 1 + d*x^2*y^2  over Fr
EDWARDS_A = R - 1  # a = -1
EDWARDS_D = 3021

# Prime-order subgroup size and cofactor (|E| = 4 * EDWARDS_ORDER).
EDWARDS_ORDER = 2111115437357092606062206234695386632838870926408408195193685246394721360383
EDWARDS_COFACTOR = 4

# Deterministic generator derivation: smallest y >= 2 yielding a curve point
# which, after cofactor clearing, has order EDWARDS_ORDER (computed lazily in
# aleo_tpu_torch.reference.edwards and memoised here by validate()).

# ---------------------------------------------------------------------------
# Limb decomposition for device kernels
# ---------------------------------------------------------------------------
# Field elements are stored as little-endian vectors of 16-bit limbs held in
# 32-bit lanes: the layout of device memory and of every public function.
# A 16x16-bit product fits a 32-bit word, and the column sums of a schoolbook
# product stay far below 2^63, so the plain arithmetic needs no carries
# inside a product. CUDA kernels pack limb pairs into 32-bit words on load.
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

FQ_LIMBS = 24  # 24 * 16 = 384 >= 377
FR_LIMBS = 16  # 16 * 16 = 256 >= 253

# Montgomery radix per field: R_mont = 2^(16 * n_limbs)
FQ_MONT_R = 1 << (LIMB_BITS * FQ_LIMBS)   # 2^384
FR_MONT_R = 1 << (LIMB_BITS * FR_LIMBS)   # 2^256

FQ_MONT_R_MOD = FQ_MONT_R % Q
FR_MONT_R_MOD = FR_MONT_R % R
FQ_MONT_R2 = (FQ_MONT_R * FQ_MONT_R) % Q
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R

# N' = -q^{-1} mod R_mont  (full-width Montgomery constant for the
# convolution-style reduction used on device).
FQ_MONT_NPRIME = (-pow(Q, -1, FQ_MONT_R)) % FQ_MONT_R
FR_MONT_NPRIME = (-pow(R, -1, FR_MONT_R)) % FR_MONT_R


def _is_probable_prime(n: int, rounds: int = 20) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    import random

    rng = random.Random(0xA1E0)
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def validate() -> None:
    """Assert internal consistency of every constant above."""
    x = BLS_X
    assert R == x**4 - x**2 + 1, "r != x^4 - x^2 + 1"
    assert Q == ((x - 1) ** 2 // 3) * R + x, "q != ((x-1)^2/3) r + x"
    assert _is_probable_prime(Q) and _is_probable_prime(R)
    assert (Q - 1) % (1 << FQ_TWO_ADICITY) == 0
    assert ((Q - 1) >> FQ_TWO_ADICITY) % 2 == 1
    assert (R - 1) % (1 << FR_TWO_ADICITY) == 0
    assert ((R - 1) >> FR_TWO_ADICITY) % 2 == 1

    # Fr two-adic root has exact order 2^47.
    w = FR_TWO_ADIC_ROOT
    assert pow(w, 1 << FR_TWO_ADICITY, R) == 1
    assert pow(w, 1 << (FR_TWO_ADICITY - 1), R) == R - 1

    # G1 generator: on curve and in the r-torsion.
    assert (G1_GEN_Y * G1_GEN_Y - (G1_GEN_X**3 + G1_B)) % Q == 0
    assert G1_COFACTOR * R == Q + 1 - (x + 1)

    # Edwards subgroup order: prime, and 4*l is within the Hasse bound of r.
    assert _is_probable_prime(EDWARDS_ORDER)
    n_pts = EDWARDS_COFACTOR * EDWARDS_ORDER
    import math

    bound = 2 * math.isqrt(R) + 1
    assert abs(n_pts - (R + 1)) <= bound, "Edwards order violates Hasse bound"

    # Montgomery constants.
    assert (Q * pow(Q, -1, FQ_MONT_R)) % FQ_MONT_R == 1
    assert (FQ_MONT_NPRIME * Q) % FQ_MONT_R == FQ_MONT_R - 1
    assert (FR_MONT_NPRIME * R) % FR_MONT_R == FR_MONT_R - 1
