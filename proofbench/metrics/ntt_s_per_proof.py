"""Transforms, seconds per proof: the program's `prove_batch/ntt` stage (it
synchronises the device around each batched transform) over one step with
the stage timers on, divided by the proofs of the step."""


def read(ctx):
    stage = (ctx.get("stages") or {}).get("prove_batch/ntt")
    return stage["seconds"] / ctx["k"] if stage else None
