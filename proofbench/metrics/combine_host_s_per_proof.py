"""The commitments' host window combine, seconds per proof: the program's
`msm/combine_host` stage (the window totals' decode and device-to-host read,
then the Horner combine on host bigints) over one step with the stage timers
on, divided by the proofs of the step."""


def read(ctx):
    stage = (ctx.get("stages") or {}).get("msm/combine_host")
    return stage["seconds"] / ctx["k"] if stage else None
