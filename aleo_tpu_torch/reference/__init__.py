"""Pure-Python exact-arithmetic oracle for the device kernel stack.

Python bigints are arbitrary precision, so everything here is exact; device
kernels are tested bit-for-bit against this package, mirroring the
reference's own oracle strategy (unmodified Rust stack as test oracle,
SURVEY.md §4). Also used on the host for the verifier, serialization and
parameter derivation — never on the proving hot path.
"""

from . import curve, edwards, field, msm, polynomial, poseidon, tower  # noqa: F401
