"""Faults planted under the timed path, to see the comparison fail.

`planted(name, unit)` breaks the program's call that a step makes:
`snark.batch.prove_batch` for the proofs, `msm.msm_batch_host` and
`msm.msm_fast_host` for the MSM. The faults: "stale", a step that returns
its state unchanged (the first call's answer every time); "half", half of the
batch left out (half of the constraint systems proven, half of the points
summed); "altered", an answer changed where it is produced (sigma_s plus one
in every proof; every point doubled). The controls are the drivers' own:
"witness" (one variable of every witness changed, which breaks the proofs'
soundness) and "top_bit" (every scalar taken mod 2^252, one bit short of
r's 253, which breaks the MSM's exactness on the ~14 % of scalars at or above
2^252 without skewing the windows' digits).
"""

from __future__ import annotations

import contextlib

from .reference import curve
from .reference.field import R

CONTROLS = {"proofs": "witness", "points": "top_bit"}


def stale(fn):
    first = []

    def call(*args, **kwargs):
        if not first:
            first.append(fn(*args, **kwargs))
        return first[0]
    return call


def _half_batch(fn):
    def call(index, cs_list, rng=None, mesh=None):
        return fn(index, cs_list[: len(cs_list) // 2], rng=rng)
    return call


def _altered_proofs(fn):
    def call(*args, **kwargs):
        proofs = fn(*args, **kwargs)
        for p in proofs:
            p.sigma_s = (p.sigma_s + 1) % R
        return proofs
    return call


def _half_points(fn):
    def call(scalars, table, c=None):
        half = scalars.shape[-2] // 2
        return fn(scalars[..., :half, :].contiguous(), table[:half].contiguous(), c)
    return call


def _altered_points(fn):
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        return [curve.add(p, p) for p in out] if isinstance(out, list) else curve.add(out, out)
    return call


WRAPS = {
    "proofs": {"stale": stale, "half": _half_batch, "altered": _altered_proofs},
    "points": {"stale": stale, "half": _half_points, "altered": _altered_points},
}


@contextlib.contextmanager
def planted(name: str, unit: str):
    """Within the block, the program's step call carries fault `name`."""
    from aleo_tpu_torch.msm import msm
    from aleo_tpu_torch.snark import batch

    targets = ([(batch, "prove_batch")] if unit == "proofs"
               else [(msm, "msm_batch_host"), (msm, "msm_fast_host")])
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in targets]
    for mod, attr, fn in saved:
        setattr(mod, attr, WRAPS[unit][name](fn))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
