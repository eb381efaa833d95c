"""Commitments, seconds per proof: the program's `kzg/commit` stage (the
MSMs of every commitment, synchronised) over one step with the stage timers
on, divided by the proofs of the step."""


def read(ctx):
    stage = (ctx.get("stages") or {}).get("kzg/commit")
    return stage["seconds"] / ctx["k"] if stage else None
